"""The dry-run's steps dispatch no op that DTensor in torch 2.11 cannot
shard: ``aten.constant_pad_nd`` (the SSM conv's pad), ``aten.index_put_``
(the MoE dispatch write), ``aten.index_put`` (the backward of an
embedding lookup written as an indexing) and ``aten.flip`` (the backward
of the SSD scan's ``cumsum``).  The tier-1 tests run a later
torch, which shards all three, so this test guards the forms that the
H100 host's release needs: it records every op that reaches the top of
the dry-run's mode stack (DTensor's level, forward and backward) while a
smoke cell is traced on a 2 x 2 fake mesh."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.common import SHAPES  # noqa: E402

aten = torch.ops.aten
UNSHARDED_IN_2_11 = {aten.constant_pad_nd.default, aten.index_put_.default,
                     aten.index_put.default, aten.flip.default}


def traced_ops(monkeypatch, arch: str, shape: str) -> set:
    """The ops ``trace_cell`` dispatches for ``arch``'s smoke config x
    ``shape`` (the cost pass: one microbatch) on a (2, 2) mesh."""
    seen: set = set()

    class Recording(TD.Reshard):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

    monkeypatch.setattr(TD, "Reshard", Recording)
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        TD.trace_cell(get_smoke_config(arch), SHAPES[shape], mesh,
                      cost_pass=True)
    return seen


@pytest.mark.parametrize("arch, shape, present", [
    ("mamba2_1_3b", "prefill_32k", aten.cat.default),
    ("mamba2_1_3b", "train_4k", aten.cumsum.default),
    ("granite_moe_3b_a800m", "prefill_32k", aten.scatter_add.default),
    ("granite_moe_3b_a800m", "train_4k", aten.gather.default),
    ("codeqwen15_7b", "train_4k", aten.embedding_dense_backward.default),
])
def test_no_op_that_torch_2_11_cannot_shard(monkeypatch, arch, shape,
                                            present):
    seen = traced_ops(monkeypatch, arch, shape)
    assert not seen & UNSHARDED_IN_2_11, sorted(map(str,
                                                    seen & UNSHARDED_IN_2_11))
    assert present in seen          # the recorder sees the step's ops
