"""``run_cell`` on the smoke config of each family's train step on a
(2, 4) fake mesh (the prefill and decode cells, and the checks, are in
``test_torch_dryrun_cells.py``)."""
import pytest

pytest.importorskip("torch")

from test_torch_dryrun_cells import FAMILIES, check_smoke_cell  # noqa: E402


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_cell_ends_ok(arch, tmp_path):
    check_smoke_cell(arch, "train_4k", tmp_path)
