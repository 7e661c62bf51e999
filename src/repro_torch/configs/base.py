"""Configuration system (the port's own copy of ``repro.configs.base``).

Every assigned architecture is expressed as a ``ModelConfig`` — a frozen
dataclass consumed by ``repro_torch.models.model``.  The same dataclass describes
dense, MoE, MLA, SSM (Mamba / xLSTM), hybrid, encoder-decoder and
stub-fronted (audio / vision) models, so that the serving engine, trainer,
sharding rules and dry-run launcher are all architecture-agnostic.

Layer layout
------------
A model is ``n_prefix_layers`` unrolled "prefix" layers (used for e.g.
DeepSeek-V2's first dense layer) followed by a *periodic body* (one
module per layer in the port):  ``block_pattern`` gives the sequence-mixer
type per position within a period (``attn`` | ``mamba`` | ``mlstm`` |
``slstm``) and ``ffn_pattern`` the channel-mixer type (``mlp`` | ``moe`` |
``none``).  ``n_layers`` counts prefix + body layers (encoder layers are
counted separately via ``n_encoder_layers``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    source: str = ""                  # citation for the assignment

    # --- norm / embeddings / misc ---
    rms_eps: float = 1e-5
    rope_theta: float = 1e4
    rope_type: str = "rope"           # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # of head_dim//2
    qkv_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- attention variant ---
    attention: str = "full"           # full | sliding
    sliding_window: int = 0           # active iff attention == "sliding"
    kv_cache_dtype: str = "compute"   # compute | int8  (beyond-paper)

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0             # 0 => standard GQA
    q_lora_rank: int = 0
    rope_head_dim: int = 0            # decoupled-RoPE head dim
    v_head_dim: int = 0               # defaults to head_dim

    # --- MoE ---
    n_experts: int = 0                # routed experts (0 => dense MLP)
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- layer layout ---
    n_prefix_layers: int = 0          # unrolled dense-MLP attn layers
    block_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("mlp",)

    # --- SSM: Mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0            # 0 => ceil(d_model / 16)

    # --- SSM: xLSTM ---
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333333

    # --- encoder-decoder ---
    n_encoder_layers: int = 0

    # --- modality frontend stub ---
    frontend: str = "none"            # none | audio | vision

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert len(self.block_pattern) == len(self.ffn_pattern), (
            self.name, self.block_pattern, self.ffn_pattern)
        body = self.n_layers - self.n_prefix_layers
        assert body >= 0
        if body:
            assert body % len(self.block_pattern) == 0, (
                f"{self.name}: body layers {body} not divisible by period "
                f"{len(self.block_pattern)}")

    # --- derived ------------------------------------------------------
    @property
    def n_body_layers(self) -> int:
        return self.n_layers - self.n_prefix_layers

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_body_layers // self.period if self.n_body_layers else 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def v_hd(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def block_type(self, pos_in_period: int) -> str:
        return self.block_pattern[pos_in_period % self.period]

    @property
    def uses_attention(self) -> bool:
        return "attn" in self.block_pattern or self.n_prefix_layers > 0 \
            or self.n_encoder_layers > 0

    @property
    def uses_kv_cache(self) -> bool:
        return self.uses_attention

    @property
    def sub_quadratic(self) -> bool:
        """True iff a 500k-token decode is feasible (no full-attn cache
        growth, or explicitly windowed)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True        # batch=1 full cache on 1-in-8 attn layers
        return self.attention == "sliding"

    # --- parameter count (analytic; used for 6ND roofline) -------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embedding included."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            if self.is_mla:
                rhd = self.rope_head_dim
                p = d * self.kv_lora_rank                      # kv down
                p += d * rhd                                   # shared k_rope
                p += self.kv_lora_rank * n_q * (hd + self.v_hd)  # kv up
                if self.q_lora_rank:
                    p += d * self.q_lora_rank
                    p += self.q_lora_rank * n_q * (hd + rhd)
                else:
                    p += d * n_q * (hd + rhd)
                p += n_q * self.v_hd * d                       # o proj
                return p
            p = d * (n_q * hd + 2 * n_kv * hd) + n_q * hd * d
            if self.qkv_bias:
                p += n_q * hd + 2 * n_kv * hd
            return p

        def mlp_params(dff: int) -> int:
            return 3 * d * dff                                  # gate,up,down

        def moe_params(active: bool) -> int:
            n_routed = self.moe_top_k if active else self.n_experts
            p = n_routed * mlp_params(self.d_expert)
            p += self.n_shared_experts * mlp_params(self.d_expert)
            p += d * self.n_experts                              # router
            return p

        def mamba_params() -> int:
            di, ds, dtr = self.d_inner, self.mamba_d_state, self.dt_rank
            p = d * 2 * di                                       # in proj
            p += di * self.mamba_d_conv + di                     # conv + bias
            p += di * (dtr + 2 * ds)                             # x -> dt,B,C
            p += dtr * di + di                                   # dt proj
            p += di * ds + di                                    # A_log, D
            p += di * d                                          # out proj
            return p

        def mlstm_params() -> int:
            di = int(self.mlstm_proj_factor * d)
            nh = max(self.n_heads, 1)
            p = d * 2 * di                                       # up proj
            p += 3 * di * (di // nh)                             # block-diag qkv
            p += 3 * di                                          # i,f,o gates (per-ch)
            p += di * d                                          # down proj
            return p

        def slstm_params() -> int:
            p = 4 * d * d + 4 * d                                # i,f,z,o proj
            p += 4 * d * (d // max(self.n_heads, 1))             # block-diag rec
            dff = max(128, int(round(self.slstm_proj_factor * d / 128))
                      * 128)
            p += 2 * d * dff                                     # ffn up/down
            return p

        total = self.vocab * d                                   # embed
        if not self.tie_embeddings:
            total += self.vocab * d                              # lm head

        def layer_params(block: str, ffn: str) -> int:
            p = 2 * d                                            # 2 rmsnorms
            if block == "attn":
                p += attn_params()
            elif block == "mamba":
                p += mamba_params()
            elif block == "mlstm":
                p += mlstm_params()
            elif block == "slstm":
                p += slstm_params()
            if ffn == "mlp":
                p += mlp_params(self.d_ff)
            elif ffn == "moe":
                p += moe_params(active_only)
            return p

        for _ in range(self.n_prefix_layers):
            total += layer_params("attn", "mlp")
        for k in range(self.n_body_layers):
            i = k % self.period
            total += layer_params(self.block_pattern[i], self.ffn_pattern[i])
        for _ in range(self.n_encoder_layers):
            # encoder: self-attn + mlp; decoder layers add cross-attn
            total += 2 * d + attn_params() + mlp_params(self.d_ff)
        if self.n_encoder_layers:
            # cross-attention in each decoder layer
            total += self.n_layers * (d + attn_params())
        total += d                                               # final norm
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int
    long_context: bool = False


INPUT_SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524288, 1,
                             long_context=True),
}


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
_REGISTRY = {}


def register(fn):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c  # noqa: F401  (populate registry)
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


def for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Adapt a config to an input shape (sliding-window for long decode)."""
    if shape.long_context and cfg.family in ("dense", "moe") \
            and cfg.attention == "full":
        return dataclasses.replace(cfg, attention="sliding",
                                   sliding_window=8192)
    return cfg


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch, shape) is a supported dry-run combination."""
    if shape.kind == "decode" and cfg.n_encoder_layers and shape.long_context:
        return False, ("enc-dec translation decoder has no 500k-token decode "
                       "regime (DESIGN.md long_500k policy)")
    return True, ""


# ----------------------------------------------------------------------
# Reduced variants
# ----------------------------------------------------------------------
def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """CPU-runnable reduced variant of the same family (<=2 body periods,
    d_model<=256, <=4 experts) used by per-arch smoke tests."""
    d = 256
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, n_heads * cfg.n_kv_heads // cfg.n_heads))
    period = cfg.period
    # shrink the period but keep every distinct block type present
    kinds = []
    for b, f in zip(cfg.block_pattern, cfg.ffn_pattern):
        if (b, f) not in kinds:
            kinds.append((b, f))
    pattern = tuple(k[0] for k in kinds)
    ffns = tuple(k[1] for k in kinds)
    n_layers = 2 * len(pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers + (1 if cfg.n_prefix_layers else 0),
        n_prefix_layers=1 if cfg.n_prefix_layers else 0,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2),
        d_expert=128 if cfg.d_expert else 0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        q_lora_rank=0,
        rope_head_dim=32 if cfg.rope_head_dim else 0,
        v_head_dim=64 if cfg.v_head_dim else 0,
        block_pattern=pattern,
        ffn_pattern=ffns,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        mamba_dt_rank=16 if "mamba" in pattern else 0,
        sliding_window=64 if cfg.attention == "sliding" else 0,
        mrope_sections=(8, 12, 12) if cfg.rope_type == "mrope"
        else cfg.mrope_sections,
        dtype="float32",
    )


def draft_variant(cfg: ModelConfig, scale: int = 4) -> ModelConfig:
    """Edge draft model: same family & vocab, ~scale^2-ish fewer params."""
    def rnd(x, m):
        return max(m, (x // scale // m) * m)
    n_heads = max(2, cfg.n_heads // scale)
    return dataclasses.replace(
        cfg,
        name=cfg.name + f"-draft{scale}x",
        n_layers=max(cfg.period + cfg.n_prefix_layers,
                     (cfg.n_body_layers // scale // cfg.period) * cfg.period
                     + cfg.n_prefix_layers),
        d_model=rnd(cfg.d_model, 128),
        n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, n_heads)),
        d_ff=rnd(cfg.d_ff, 128) if cfg.d_ff else 0,
        d_expert=rnd(cfg.d_expert, 64) if cfg.d_expert else 0,
        kv_lora_rank=rnd(cfg.kv_lora_rank, 64) if cfg.kv_lora_rank else 0,
        q_lora_rank=0,
        n_encoder_layers=max(2, cfg.n_encoder_layers // scale)
        if cfg.n_encoder_layers else 0,
    )
