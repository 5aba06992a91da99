"""Model and training configuration dataclasses (the port's own copy of
vlm_bridge_tpu.configs: same classes, fields, defaults and presets, held
equal by tests/test_torch_port.py).

Model configs are frozen (hashable). The training config mirrors the
reference YAML schema key-for-key (reference: config/training-default.yaml
and src/vlm_bridge/training_strategy/training_setup.py:23-96) plus the JAX
package's own fields, so one YAML file serves both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DinoV2Config:
    """DINOv2 ViT configuration (HF `facebook/dinov2-*` family)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    # Native pretraining grid: image_size // patch_size per side. dinov2-large is
    # trained at 518 (37x37 patches); the captioning pipeline feeds 224 (16x16)
    # and the position embeddings are bicubically interpolated.
    image_size: int = 518
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    qkv_bias: bool = True
    use_swiglu_ffn: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def native_grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def swiglu_hidden(self) -> int:
        """SwiGLU FFN width (HF Dinov2SwiGLUFFN: 2/3 of mlp_ratio*hidden,
        rounded up to a multiple of 8)."""
        hf = int(self.hidden_size * self.mlp_ratio)
        return (int(hf * 2 / 3) + 7) // 8 * 8

    @staticmethod
    def large() -> "DinoV2Config":
        """facebook/dinov2-large: 304M params, output [B, 257, 1024] @ 224px."""
        return DinoV2Config()

    @staticmethod
    def base() -> "DinoV2Config":
        """facebook/dinov2-base: 86M params, hidden 768."""
        return DinoV2Config(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def giant() -> "DinoV2Config":
        """facebook/dinov2-giant: 1.1B params, hidden 1536 (SwiGLU FFN)."""
        return DinoV2Config(hidden_size=1536, num_layers=40, num_heads=24,
                            use_swiglu_ffn=True)

    @staticmethod
    def tiny_test() -> "DinoV2Config":
        """Small config for tests (matches an HF Dinov2Config with same fields)."""
        return DinoV2Config(
            hidden_size=32, num_layers=2, num_heads=4, mlp_ratio=2,
            patch_size=14, image_size=70,
        )


@dataclass(frozen=True)
class Gemma2Config:
    """Gemma-2 decoder configuration (HF `google/gemma-2-*` family)."""

    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0
    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 2
    attention_bias: bool = False

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """Gemma-2 alternates sliding/global attention; even layers (0-indexed)
        are sliding (HF: `"sliding_attention" if bool((i + 1) % 2)`)."""
        return (layer_idx + 1) % 2 == 1

    @property
    def attn_scale(self) -> float:
        return self.query_pre_attn_scalar ** -0.5

    @staticmethod
    def gemma2_2b() -> "Gemma2Config":
        return Gemma2Config()

    @staticmethod
    def gemma2_9b() -> "Gemma2Config":
        return Gemma2Config(
            hidden_size=3584, intermediate_size=14336, num_layers=42,
            num_heads=16, num_kv_heads=8, head_dim=256,
        )

    @staticmethod
    def gemma2_27b() -> "Gemma2Config":
        """google/gemma-2-27b: hidden 4608, FFN 36864, 46 layers, 32 q /
        16 kv heads, head_dim 128. Unlike 2b/9b, query_pre_attn_scalar is
        hidden/num_heads = 144 (HF config.json), not head_dim."""
        return Gemma2Config(
            hidden_size=4608, intermediate_size=36864, num_layers=46,
            num_heads=32, num_kv_heads=16, head_dim=128,
            query_pre_attn_scalar=144.0,
        )

    @staticmethod
    def tiny_test(vocab_size: int = 512) -> "Gemma2Config":
        return Gemma2Config(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=8, query_pre_attn_scalar=16.0,
            max_position_embeddings=128,
        )


@dataclass(frozen=True)
class BridgeConfig:
    """Bridge-Lite adapter configuration.

    Matches the reference architecture exactly so weights are interchangeable:
    per block = cross-attention (text Q @ language_dim, vision K/V @ vision_dim,
    internal d_model = language_dim, 8 heads) + non-causal self-attention
    (18 heads) + FFN (x4, GELU), all pre-LN with residuals.
    Reference: src/vlm_bridge/model_architecture/bridge_module.py:240-404.
    """

    vision_dim: int = 1024
    language_dim: int = 2304
    num_blocks: int = 2
    num_heads_cross: int = 8
    num_heads_self: int = 18
    ffn_mult: int = 4
    dropout: float = 0.1  # FullModel default (full_model.py:38); BridgeLite standalone uses 0.2
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default

    @staticmethod
    def default() -> "BridgeConfig":
        return BridgeConfig()

    @staticmethod
    def tiny_test() -> "BridgeConfig":
        return BridgeConfig(
            vision_dim=32, language_dim=64, num_blocks=2,
            num_heads_cross=2, num_heads_self=4, ffn_mult=2,
        )


@dataclass(frozen=True)
class Gemma2MoEConfig(Gemma2Config):
    """The port's decoder block with a routed feed-forward in every layer
    (this port only; the JAX package has no sparse decoder). Each token's
    pre-FFN-normed row h picks `experts_per_token` of `num_experts` GeGLU
    experts of width `moe_intermediate_size`: p = softmax(h @ router) in f32,
    the top k by p (ties to the lower index), weights p_sel / sum(p_sel)
    with `norm_topk_prob` (else p_sel), y = sum of the weighted experts.
    `intermediate_size` is the published dense width, which no layer uses.
    `full_every` > 0: layer i attends fully where (i + 1) % full_every == 0
    and through the window elsewhere (0: Gemma-2's alternation)."""

    num_experts: int = 64
    experts_per_token: int = 8
    moe_intermediate_size: int = 896
    norm_topk_prob: bool = True
    full_every: int = 0

    def layer_is_sliding(self, layer_idx: int) -> bool:
        if self.full_every:
            return (layer_idx + 1) % self.full_every != 0
        return super().layer_is_sliding(layer_idx)

    @staticmethod
    def mellum2_12b() -> "Gemma2MoEConfig":
        """JetBrains/Mellum2-12B-A2.5B's widths on the port's block: 28
        layers, hidden 2304, 32 query over 4 KV heads of 128, 64 experts of
        width 896, 8 a token, a 1024-row window on three layers of four,
        rope theta 500,000, vocabulary 98,304 (portbench's configuration file
        lists the departures)."""
        return Gemma2MoEConfig(
            vocab_size=98304, hidden_size=2304, intermediate_size=7168, num_layers=28,
            num_heads=32, num_kv_heads=4, head_dim=128, max_position_embeddings=131072,
            rms_norm_eps=1e-6, rope_theta=500000.0, query_pre_attn_scalar=128.0,
            sliding_window=1024, num_experts=64, experts_per_token=8,
            moe_intermediate_size=896, norm_topk_prob=True, full_every=4)

    @staticmethod
    def tiny_test(vocab_size: int = 512) -> "Gemma2MoEConfig":
        """8 query heads over one KV head of 32, 8 experts of 64, 2 a token; a
        64-row window, which the fused decode's cache rows fit."""
        return Gemma2MoEConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128, num_layers=4,
            num_heads=8, num_kv_heads=1, head_dim=32, sliding_window=64,
            query_pre_attn_scalar=32.0, max_position_embeddings=128, num_experts=8,
            experts_per_token=2, moe_intermediate_size=64, full_every=4)


def num_experts(cfg: Gemma2Config) -> int:
    """Routed experts a layer of this decoder has (0: a dense feed-forward)."""
    return getattr(cfg, "num_experts", 0)


@dataclass(frozen=True)
class VLMConfig:
    """Full Encoder-Adapter-Decoder model configuration."""

    vision: DinoV2Config = field(default_factory=DinoV2Config.large)
    lm: Gemma2Config = field(default_factory=Gemma2Config.gemma2_2b)
    bridge: BridgeConfig = field(default_factory=BridgeConfig.default)
    image_size: int = 224  # pipeline input resolution (reference uses 224)

    @property
    def num_vision_tokens(self) -> int:
        return (self.image_size // self.vision.patch_size) ** 2 + 1

    @staticmethod
    def default() -> "VLMConfig":
        return VLMConfig()

    @staticmethod
    def gemma2_9b() -> "VLMConfig":
        """Scaled variant: DINOv2-large + Gemma-2-9B (hidden 3584). Needs the
        mesh "model" axis (tensor parallelism) — 9B bf16 weights do not
        replicate comfortably on 16GB chips. Bridge head counts keep the
        reference's per-head dims (cross 8 heads; self 128-dim heads)."""
        lm = Gemma2Config.gemma2_9b()
        bridge = BridgeConfig(
            vision_dim=1024, language_dim=lm.hidden_size,
            num_heads_cross=8, num_heads_self=28,
        )
        return VLMConfig(lm=lm, bridge=bridge)

    @staticmethod
    def gemma2_27b() -> "VLMConfig":
        """DINOv2-large + Gemma-2-27B. 27B never fits one 16 GB chip (int8
        alone is ~27 GB): the mesh "model" axis is mandatory (TP ≥ 4 for
        bf16, ≥ 2 int8-weight serving). Bridge keeps the reference's
        per-head dims (cross 8 heads; self 4608/128 = 36 heads)."""
        lm = Gemma2Config.gemma2_27b()
        bridge = BridgeConfig(
            vision_dim=1024, language_dim=lm.hidden_size,
            num_heads_cross=8, num_heads_self=36,
        )
        return VLMConfig(lm=lm, bridge=bridge)

    @staticmethod
    def tiny_test() -> "VLMConfig":
        return VLMConfig(
            vision=DinoV2Config.tiny_test(), lm=Gemma2Config.tiny_test(),
            bridge=BridgeConfig.tiny_test(), image_size=70)

    @staticmethod
    def tiny_ref() -> "VLMConfig":
        """Reference-instantiable tiny dims for the offline parity
        rehearsal: the ACTUAL reference FullModel class (reference
        full_model.py:33-80) builds its BridgeLite from the loaded models'
        output dims with num_heads_self hardcoded to 18 and num_heads_cross
        defaulting to 8, so language_dim must divide both (72 works); the
        vision tower runs the real 224/14 grid so the reference's
        BitImageProcessor path and our host_resize_crop see identical
        geometry (tests/test_full_flow_rehearsal.py)."""
        vision = DinoV2Config(
            hidden_size=32, num_layers=2, num_heads=4, mlp_ratio=2,
            patch_size=14, image_size=224)
        lm = Gemma2Config(
            vocab_size=512, hidden_size=72, intermediate_size=144,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=8, query_pre_attn_scalar=16.0,
            max_position_embeddings=128)
        bridge = BridgeConfig(
            vision_dim=32, language_dim=72, num_blocks=2,
            num_heads_cross=8, num_heads_self=18, ffn_mult=4)
        return VLMConfig(vision=vision, lm=lm, bridge=bridge,
                         image_size=224)


# ---------------------------------------------------------------------------
# Training config (YAML schema parity with the reference)
# ---------------------------------------------------------------------------


@dataclass
class TrainingConfig:
    """Training configuration.

    The first block of fields matches the reference YAML schema exactly
    (reference: config/training-default.yaml, training_setup.py:23-67) so
    existing config files work unmodified. TPU-specific fields follow.
    """

    # --- reference-compatible fields -------------------------------------
    batch_size: int = 8
    num_epochs: int = 12
    learning_rate: float = 1.0e-5
    min_lr: float = 1.0e-6
    weight_decay: float = 0.01
    gradient_clip_val: float = 0.3
    use_scheduler: bool = True
    scheduler_type: str = "cosine"  # cosine | linear | constant
    use_amp: bool = True
    amp_dtype: str = "bfloat16"
    data_dir: str = "data/groundcap"
    num_workers: int = 4
    checkpoint_dir: str = "checkpoints/experiment"
    log_dir: str = "logs/experiment"
    log_every_n_steps: int = 10
    save_every_n_epochs: int = 1
    val_every_n_epochs: int = 1
    generate_samples_every_n_epochs: int = 1
    num_validation_samples: int = 3
    use_early_stopping: bool = True
    early_stopping_patience: int = 3
    early_stopping_min_delta: float = 0.01
    device: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None

    # --- fields added by the JAX package ------------------------------------
    # Kept so YAML files stay interchangeable. The port ignores the JAX-only
    # ones: mesh_axis_names, pad_to_buckets, scan_layers, profile_* and
    # validation_strategy_sweep. mesh_shape is read (training/stack.py).
    # (data,) or (data, model); data == -1 means "all remaining processes".
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    max_text_len: int = 512                      # hard truncation, matches reference
    pad_to_buckets: Tuple[int, ...] = (64, 128, 256, 512)  # static-shape buckets
    mask_pad_loss: bool = True                   # fix of reference bug (pads in loss)
    bridge_causal: bool = False                  # causal bridge self-attn: removes the
                                                 # reference's next-token leak + its
                                                 # train/serve mismatch (bridge.forward)
    remat_lm: bool = True                        # rematerialize frozen LM layers
    scan_layers: bool = False                    # lax.scan over (sliding, global)
                                                 # LM layer pairs: trace is 2
                                                 # layers deep instead of an
                                                 # unrolled 26/42-layer graph —
                                                 # cuts the ~8 min/bucket train
                                                 # compile (gemma2.
                                                 # stack_layers_for_scan)
    seed: int = 0
    model_preset: str = "default"                # default | tiny_test
    hf_vision_path: Optional[str] = None         # local dir with safetensors
    hf_lm_path: Optional[str] = None
    tokenizer_path: Optional[str] = None
    loss_chunk_size: int = 128                   # seq chunking for the 256k-vocab CE
    loss_remat: bool = True                      # rematerialize per-chunk logits
    max_steps_per_epoch: Optional[int] = None    # truncate (tests / smoke runs)
    precache_pixels: bool = False                # build the uint8 pixel cache
                                                 # once at startup (epochs then
                                                 # stream a memmap, no JPEG
                                                 # re-decode; vlm-data precache
                                                 # does the same offline)
    profile_trace_dir: Optional[str] = None      # capture a profiler trace here
    profile_start_step: int = 10                 # trace window start (epoch-local)
    profile_num_steps: int = 5                   # trace window length
    validation_strategy_sweep: bool = False      # robust sweep on 1st val
                                                 # sample (5 extra jit traces)
    gradient_accumulation_steps: int = 1         # microbatches per optimizer step

    # ------------------------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str | Path) -> "TrainingConfig":
        """Load from YAML; unknown keys ignored, missing keys defaulted.

        Mirrors reference `TrainingConfig.from_yaml` semantics
        (training_setup.py:69-88): a missing file yields defaults.
        """
        import yaml

        path = Path(path)
        if not path.exists():
            return cls()
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k not in names:
                continue
            # YAML gives lists; tuple-typed fields need tuples (hashable/static).
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    def to_yaml(self, path: str | Path) -> None:
        import yaml

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        d = dataclasses.asdict(self)
        d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
        with open(path, "w") as f:
            yaml.safe_dump(d, f, default_flow_style=False, sort_keys=True)

    def model_config(self) -> VLMConfig:
        if self.model_preset == "tiny_test":
            return VLMConfig.tiny_test()
        if self.model_preset == "tiny_test_wide":
            # tiny dims with a sliding window that never binds at caption
            # lengths — qualifies the fused (interpret-mode) decode stack so
            # the memorization proof can score the QUANTIZED serving recipes
            # through the real kernels (tools/memorize.run_proof)
            base = VLMConfig.tiny_test()
            return dataclasses.replace(
                base, lm=dataclasses.replace(base.lm, sliding_window=128))
        if self.model_preset == "gemma2_9b":
            return VLMConfig.gemma2_9b()
        if self.model_preset == "gemma2_27b":
            return VLMConfig.gemma2_27b()
        if self.model_preset != "default":
            raise ValueError(f"unknown model_preset: {self.model_preset}")
        return VLMConfig.default()
