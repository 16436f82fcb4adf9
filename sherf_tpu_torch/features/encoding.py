"""NeRF positional encoding (torch counterpart of
``sherf_tpu/features/encoding.py``).

Layout: [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
f_k = 2^k, built as ONE sine over a (..., 2Fd) tensor with cos(a) =
sin(a + pi/2) — the same folded form, and so the same rounding, as the JAX
package's default path.
"""

from __future__ import annotations

import numpy as np
import torch


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """x: (..., d) -> (..., d * 2 * num_freqs [+ d])."""
    freqs = 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)
    d = x.shape[-1]
    fcol = torch.as_tensor(np.repeat(freqs, 2 * d).astype(np.float32),
                           device=x.device)
    pcol = torch.as_tensor(
        np.tile(np.repeat(np.asarray([0.0, np.pi / 2], np.float32), d),
                num_freqs), device=x.device)
    xt = torch.cat([x] * (2 * num_freqs), dim=-1)
    enc = torch.sin(xt * fcol + pcol)
    if include_input:
        return torch.cat([x, enc.to(x.dtype)], dim=-1)
    return enc
