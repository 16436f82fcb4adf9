from sherf_tpu_torch.train.ssim import ssim
from sherf_tpu_torch.train.loss import reconstruction_loss, img2mse, mse2psnr
from sherf_tpu_torch.train.train_state import (
    TrainState, create_train_state, ema_beta, ema_update, step_lr_schedule,
    zero_nans)
from sherf_tpu_torch.train.step import make_train_step
from sherf_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from sherf_tpu_torch.train.stats import StatsCollector
from sherf_tpu_torch.train.loop import training_loop

__all__ = [
    "ssim", "reconstruction_loss", "img2mse", "mse2psnr", "TrainState",
    "create_train_state", "ema_beta", "ema_update", "step_lr_schedule",
    "zero_nans", "make_train_step", "latest_checkpoint", "restore_checkpoint",
    "save_checkpoint", "StatsCollector", "training_loop",
]
