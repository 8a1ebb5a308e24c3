from .steps import (TrainState, decode_fn, make_decode_step,
                    make_prefill_step, make_train_step, train_state_init)

__all__ = ["TrainState", "decode_fn", "make_decode_step",
           "make_prefill_step", "make_train_step", "train_state_init"]
