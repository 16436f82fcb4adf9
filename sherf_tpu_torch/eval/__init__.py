from sherf_tpu_torch.eval.metrics import crop_metrics, psnr_np, ssim_np
from sherf_tpu_torch.eval.png import write_png
from sherf_tpu_torch.eval.test_loop import run_eval, to8b

__all__ = ["crop_metrics", "psnr_np", "run_eval", "ssim_np", "to8b",
           "write_png"]
