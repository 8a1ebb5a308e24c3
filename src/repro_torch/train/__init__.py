from .steps import decode_fn, make_decode_step, make_prefill_step

__all__ = ["decode_fn", "make_decode_step", "make_prefill_step"]
