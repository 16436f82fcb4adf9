from sherf_tpu_torch.models.generator import (SHERFGenerator, init_weights_,
                                              random_init_)

__all__ = ["SHERFGenerator", "init_weights_", "random_init_"]
