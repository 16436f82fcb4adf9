from sherf_tpu_torch.data.synthetic import make_synthetic_batch, synthetic_camera

__all__ = ["make_synthetic_batch", "synthetic_camera"]
