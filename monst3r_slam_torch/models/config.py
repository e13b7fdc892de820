"""Static model configuration for the CroCo/MASt3R/MonST3R family.

The port's own copy of the JAX package's `models/config.py`: the same frozen
dataclass and the same published configurations, so one config value names
the same architecture in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # ViT encoder (CroCo ViT-L)
    patch_size: int = 16
    enc_depth: int = 24
    enc_dim: int = 1024
    enc_heads: int = 16
    # Dual cross-attention decoder
    dec_depth: int = 12
    dec_dim: int = 768
    dec_heads: int = 12
    mlp_ratio: int = 4
    # RoPE2D positional encoding ('RoPE100')
    rope_freq: float = 100.0
    # Heads
    desc_dim: Optional[int] = 24  # None => plain DUSt3R (no descriptor head)
    two_confs: bool = True
    depth_mode: Tuple[str, float, float] = ("exp", -INF, INF)
    conf_mode: Tuple[str, float, float] = ("exp", 1.0, INF)
    desc_conf_mode: Tuple[str, float, float] = ("exp", 0.0, INF)
    desc_hidden_factor: float = 4.0
    # DPT head dims
    feature_dim: int = 256
    last_dim: int = 128
    layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        assert self.enc_dim % self.enc_heads == 0
        return self.enc_dim // self.enc_heads

    @property
    def dec_head_dim(self) -> int:
        assert self.dec_dim % self.dec_heads == 0
        return self.dec_dim // self.dec_heads

    @property
    def hooks(self) -> Tuple[int, int, int, int]:
        # DPT hooks into [enc_out, dec_block_6, dec_block_9, dec_block_12]
        l2 = self.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)

    @property
    def dpt_in_dims(self) -> Tuple[int, int, int, int]:
        return (self.enc_dim, self.dec_dim, self.dec_dim, self.dec_dim)

    @property
    def head_out_channels(self) -> int:
        return 4  # pts3d(3) + conf(1)


# Published MASt3R ViT-L 512 configuration
MAST3R_512 = ModelConfig()

# MonST3R: DUSt3R-style weights, no descriptor head and one confidence; the
# dynamic pipeline takes D and Q from the MASt3R decoder run on the same
# encoder features (dynamic/inference.py).
MONST3R_512 = ModelConfig(desc_dim=None, two_confs=False)

# Tiny config for unit tests (same topology, small dims)
TINY = ModelConfig(
    patch_size=16,
    enc_depth=4,
    enc_dim=64,
    enc_heads=4,
    dec_depth=4,
    dec_dim=48,
    dec_heads=4,
    feature_dim=32,
    last_dim=16,
    layer_dims=(16, 24, 32, 48),
)
