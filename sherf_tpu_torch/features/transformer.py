"""Tri-plane token transformer (torch counterpart of
``sherf_tpu/features/transformer.py``): depth-1, 3-head attention over the
3 plane tokens of each sample point, then a GELU MLP, both pre-norm and
residual."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sherf_tpu_torch.features.layers import Dense, LayerNorm


class Attention(nn.Module):
    def __init__(self, dim: int = 32, heads: int = 3, dim_head: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.project = not (heads == 1 and dim_head == dim)
        if self.project:
            self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., n, dim) -> (..., n, dim)."""
        inner = self.heads * self.dim_head
        qkv = self.to_qkv(x)
        split = lambda t: t.reshape(*t.shape[:-1], self.heads, self.dim_head)
        q = split(qkv[..., :inner])                      # (..., n, h, d)
        k = split(qkv[..., inner:2 * inner])
        v = split(qkv[..., 2 * inner:])
        logits = (q[..., :, None, :, :] * k[..., None, :, :, :]).sum(-1) \
            * self.dim_head ** -0.5                      # (..., i, j, h)
        e = torch.exp(logits - logits.amax(dim=-2, keepdim=True))
        p = e / e.sum(dim=-2, keepdim=True)
        out = (p[..., None] * v[..., None, :, :, :]).sum(dim=-3)  # (..., i, h, d)
        out = out.reshape(*out.shape[:-2], inner)
        return self.to_out(out) if self.project else out


class FeedForward(nn.Module):
    def __init__(self, dim: int = 32, hidden: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        # flax nn.gelu is the tanh approximation
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PlaneTransformer(nn.Module):
    def __init__(self, dim: int = 32, depth: int = 1, heads: int = 3,
                 dim_head: int = 16, mlp_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", Attention(dim, heads, dim_head, dtype))
            self.add_module(f"ff_norm_{i}", LayerNorm(dim))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., n_tokens, dim)."""
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(x))
            x = x + getattr(self, f"ff_{i}")(getattr(self, f"ff_norm_{i}")(x))
        return x
