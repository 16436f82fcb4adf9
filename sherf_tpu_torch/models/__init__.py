from sherf_tpu_torch.models.generator import SHERFGenerator, random_init_

__all__ = ["SHERFGenerator", "random_init_"]
