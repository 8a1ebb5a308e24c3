from .analyze import (COLLECTIVE_OPS, StepCounter, model_flops,
                      roofline_terms)

__all__ = ["COLLECTIVE_OPS", "StepCounter", "model_flops", "roofline_terms"]
