"""End-to-end subject-to-video pipeline (counterpart of
``s2v_tpu/pipelines/s2v.py::S2VPipeline``).

T5 prompt encode (cond + uncond) -> VAE encode of the subject image ->
segmented RoPE tables -> the CFG denoise loop -> VAE decode -> postprocess.
``S2VPipeline.from_pretrained`` loads a diffusers-layout CogVideoX snapshot
(and merges a subject LoRA checkpoint); the pipeline can also be built from
its components: parameter dicts in the port's layouts (random, or carried
across with ``s2v_torch.loaders.jax_params``) and their configs.  Everything
runs on ``device`` (CUDA unless the caller passes ``device="cpu"``), except
a T5 the caller placed on the host (``text_encoder_device="host"``).

Positions: RoPE tables for the 5b family, the sincos ``[text | video]``
table for a model without RoPE (the 2b family, ``prepare_pos_embedding``).
``pipelines/variants.py`` holds t2v, i2v, fun-control and v2v on the same
components.

CogVideoX1.5 (``TransformerConfig.patch_size_t``): tokens are 2x2x2 patches
over (time, height, width).  ``generate`` draws (or takes) the latents at the
frame count padded to a multiple of ``patch_size_t`` (81 frames: 21 latent
frames padded to 22), as diffusers' ``CogVideoXPipeline`` does, returns them
padded as ``latent`` output and drops the leading padding frames only on the
way to the decode; the RoPE table is the integer grid of the temporal patches
(``prepare_rope``).  Such a model generates on one card through the exact
attention backends: a mesh, int8 linears, the windowed, sequence-parallel
and int8 backends, the variants and the trainers raise on it.

Subject adapters: ``load_lora(path)`` re-merges the base weights with
another checkpoint, ``load_lora(path, mode="runtime")`` attaches its
low-rank factors instead (the DiT applies them per layer); ``None``
restores the base weights.  ``save_pretrained`` writes a diffusers-layout
snapshot.

int8 serving: ``pipe.transformer_params =
quantize_transformer_params(pipe.transformer_params)`` (int8 linears, see
``s2v_torch/ops/quant.py``) and ``pipe.set_attention("flash_int8")`` (kernel
B3); ``generate`` runs the int8 tree unchanged.

Across cards: ``pipe.set_mesh("dp2,tp2,sp2")`` (a spec, a dict of sizes, or
a ``DeviceMesh`` whose dims are named ``data``, ``seq`` and ``model``), one
process per card, every rank building the same pipeline and calling
``generate`` with the same arguments (``torchrun``, see ``cli.py``).  A
``model`` dim slices the DiT's params in place for megatron TP (bf16 or int8
trees; ``parallel/sharding.py``), and with ``text_encoder_device="mesh"``
T5's; a ``data`` dim splits the batched CFG's rows.  On a ring above 1
``generate``
routes ``flash`` to ``sp_allgather``, ``flash_int8`` to ``sp_int8`` and
``windowed`` to ``sp_windowed``, as JAX does; an explicit sequence-parallel
backend (``sp_allgather``, ``sp_ulysses``, ``ring``, ``sp_int8``,
``sp_windowed``) runs on a ring of 1 too.  The DiT shards its video stream
by latent frames over the ranks (``models/transformer.py``), and the VAE
decode runs context-parallel when the ring can take its chunks
(``decode_latents``).  Every rank ends with the same clip.
"""

from __future__ import annotations

import functools
import gc
import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field, replace
from typing import Optional, Union

import numpy as np
import torch

from s2v_torch.config import PipelineConfig, SchedulerConfig, T5Config, TransformerConfig, VAEConfig
from s2v_torch.loaders.hf import convert_t5_state_dict, convert_transformer_state_dict, convert_vae_state_dict
from s2v_torch.loaders.lora import load_and_merge_lora, load_runtime_lora
from s2v_torch.loaders.resolve import resolve_model_dir
from s2v_torch.loaders.safetensors_io import load_sharded_safetensors
from s2v_torch.models.t5 import t5_encode
from s2v_torch.models.transformer import FRAME_BACKENDS, RUNTIME_LORA_KEY, token_grid
from s2v_torch.models.vae import gaussian_sample, vae_decode, vae_encode
from s2v_torch.ops.attention import WINDOWED_BACKENDS, resolve_attention_backend, route_seq_backend
from s2v_torch.ops.rope import build_segmented_rope, prepare_video_and_ref_rope, prepare_video_and_ref_rope_patches
from s2v_torch.ops.sincos import joint_text_video_pos_embedding
from s2v_torch.parallel.context import default_logical_map, mesh_context
from s2v_torch.pipelines.denoise import (
    DenoiseSchedule,
    DPMNoise,
    adaptive_init_carry,
    cfg_skip_steps,
    make_segmented_denoise,
)
from s2v_torch.utils.device import resolve_device
from s2v_torch.utils.logging import get_logger, phase, span_attrs, span_device
from s2v_torch.utils.video import denormalize_video, load_image, to_uint8_frames

PROMPT_CACHE_SIZE = 32
# runtime adapters kept on the host for re-selection, least recently used out
RUNTIME_LORA_CACHE_SIZE = 4
OUTPUT_TYPES = ("np", "pil", "pt", "latent")
# free device bytes below which the untiled decode is not tried: tiled
# below DECODE_UNTILED_MIN_FREE, quarter-size tiles below DECODE_TILED_MIN_FREE
DECODE_UNTILED_MIN_FREE = 5.5e9
DECODE_TILED_MIN_FREE = 2.5e9


def _on_card(method):
    """Runs a pipeline method with the pipeline's card as the current CUDA
    device, so that its spans time the stream its work runs on."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with span_device(self.device):
            return method(self, *args, **kwargs)

    return wrapper


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to(tree, device: torch.device):
    """A tree of tensors moved to ``device`` in one pass."""
    return _tree_map(lambda t: t.to(device), tree)


def _has_int8(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_int8(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_int8(v) for v in tree)
    return getattr(tree, "dtype", None) == torch.int8


@dataclass
class S2VPipeline:
    """Holds parameters and configs; ``generate`` is the entry point."""

    transformer_params: dict
    transformer_cfg: TransformerConfig
    vae_params: dict
    vae_cfg: VAEConfig
    t5_params: Optional[dict] = None
    t5_cfg: Optional[T5Config] = None
    scheduler_cfg: SchedulerConfig = field(default_factory=SchedulerConfig)
    # generate()'s defaults for every argument it is not given
    pipeline_cfg: PipelineConfig = field(default_factory=PipelineConfig)
    tokenizer: Optional[object] = None  # .encode(prompts, max_length) -> int ids
    device: Optional[Union[str, torch.device]] = None
    # "auto": the flash kernel on CUDA, the plain fp32 attention on the CPU;
    # set_attention selects another backend (flash_int8, a windowed one and its width)
    attention_backend: str = "auto"
    # "auto" tiles the VAE only when the frame exceeds the VAE's sample size
    # (so 480x720 decodes untiled, the exact decoder output); True / False force it
    vae_tiling: object = "auto"
    vae_slicing: bool = True
    # a DeviceMesh with dims named data, seq and model (set_mesh), or None: one card
    mesh: Optional[object] = None
    # T5 runs on the mesh (from_pretrained(text_encoder_device="mesh")):
    # sliced over its model dim, replicated over the others
    t5_on_mesh: bool = False
    # the resolved snapshot dir of from_pretrained: load_lora re-reads the
    # base weights from it, save_pretrained copies its tokenizer files
    model_dir: Optional[str] = None
    # True: T5 runs in fp32 on the CPU (text_encoder_device="host"); its
    # embeddings move to the device
    t5_on_host: bool = False
    # host-clock seconds of the last generate()'s stages, each ended by a device sync
    timings: dict = field(default_factory=dict, repr=False)
    # counts of the last generate(): steps run, cfg-skipped and adaptive-skipped steps, and the
    # clip's tokens (text, ref, video) and padding latent frames, also attributes of its s2v.prologue span
    stats: dict = field(default_factory=dict, repr=False)
    # the DPM noise source, noise(i, shape, device) -> (n1, n2); None draws
    # from pipelines.denoise.DPMNoise seeded from generate()'s seed
    dpm_noise: Optional[object] = field(default=None, repr=False)
    # the variants' noise source (pipelines/variants.py), noise(name, shape)
    # -> a CPU fp32 tensor; None draws from generators seeded from the seed
    variant_noise: Optional[object] = field(default=None, repr=False)
    _prompt_embed_cache: dict = field(default_factory=dict, repr=False)
    # the pre-merge transformer state dict (host, memory-mapped), kept by
    # load_lora(cache_base=True) so that later swaps skip the snapshot read
    _base_transformer_sd: Optional[dict] = field(default=None, repr=False)
    # (realpath, alpha) of the adapter merged into the weights, or None
    _merged_lora: Optional[tuple] = field(default=None, repr=False)
    # (realpath, alpha) -> runtime factor tree on the host, LRU order
    _runtime_lora_cache: dict = field(default_factory=dict, repr=False)
    # set once only the quarter-tile decode fits: later decodes go straight there
    _decode_lean: bool = field(default=False, repr=False)
    # the placements of the transformer's and T5's model-dim slices (set_mesh), None while whole
    _tp_specs: Optional[dict] = field(default=None, repr=False)
    _t5_specs: Optional[dict] = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        lora_checkpoint: Optional[str] = None,
        lora_alpha: float = 64.0,
        dtype: torch.dtype = torch.bfloat16,
        attention_backend: str = "auto",
        quantize_int8: bool = False,
        text_encoder_device: str = "auto",
        disentangled_modulation: bool = False,
        mesh=None,
        cache_dir: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "S2VPipeline":
        """Load a CogVideoX snapshot (a local diffusers-layout dir with
        transformer/ vae/ [text_encoder/ tokenizer/ scheduler/], or a hub
        repo id, see ``loaders/resolve.py``), merging a subject LoRA
        checkpoint into the DiT if given (``s2v_tpu/pipelines/s2v.py:199``).

        ``text_encoder_device``: ``"auto"``/``"device"`` put T5 on
        ``device``; ``"host"`` keeps it on the CPU in fp32; ``"mesh"`` puts
        it on the mesh (sliced over its ``model`` dim, ``s2v_tpu``'s
        ``t5_on_mesh``), which needs ``mesh``.
        ``mesh``: a spec, dict or ``DeviceMesh``, see :meth:`set_mesh`.
        ``disentangled_modulation=True`` keeps each block's pre-merge adaLN
        linears beside the merged ones (video and text are modulated by
        the base weights, the ref stream by the adapted ones)."""
        if text_encoder_device not in ("auto", "device", "host", "mesh"):
            raise ValueError(f"text_encoder_device must be auto | device | host | mesh, got {text_encoder_device!r}")
        if text_encoder_device == "mesh" and mesh is None:
            raise ValueError('text_encoder_device="mesh" needs mesh=...')
        device = resolve_device(device)
        model_dir = resolve_model_dir(model_dir, cache_dir=cache_dir)

        t_cfg = TransformerConfig.from_hf_config(os.path.join(model_dir, "transformer", "config.json"), dtype=dtype)
        if quantize_int8:
            t_cfg.require_frame_patches("int8 linears (quantize_int8)")
        sd = load_sharded_safetensors(os.path.join(model_dir, "transformer"))
        if disentangled_modulation:
            t_cfg = replace(t_cfg, disentangled_modulation=True)
            _add_base_linears(sd, t_cfg.num_layers)
        if lora_checkpoint is not None:
            sd, _ = load_and_merge_lora(sd, lora_checkpoint, alpha=lora_alpha)
        transformer_params = _to(convert_transformer_state_dict(sd, t_cfg, quantize_int8=quantize_int8), device)
        del sd

        v_cfg = VAEConfig.from_hf_config(os.path.join(model_dir, "vae", "config.json"), dtype=dtype)
        vae_params = _to(convert_vae_state_dict(load_sharded_safetensors(os.path.join(model_dir, "vae")), v_cfg),
                         device)

        t5_dir = os.path.join(model_dir, "text_encoder")
        t5_params = t5_cfg = tokenizer = None
        t5_on_host = text_encoder_device == "host"
        if os.path.isdir(t5_dir):
            # on the host T5 runs in fp32: CPUs emulate bf16
            t5_cfg = T5Config.from_hf_config(os.path.join(t5_dir, "config.json"),
                                             dtype=torch.float32 if t5_on_host else dtype)
            t5_params = _to(convert_t5_state_dict(load_sharded_safetensors(t5_dir), t5_cfg),
                            torch.device("cpu") if t5_on_host else device)
            tokenizer = _load_tokenizer(model_dir)

        sched_path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
        scheduler_cfg = SchedulerConfig.from_hf_config(sched_path) if os.path.exists(sched_path) else SchedulerConfig()
        pipe = cls(
            transformer_params=transformer_params, transformer_cfg=t_cfg, vae_params=vae_params, vae_cfg=v_cfg,
            t5_params=t5_params, t5_cfg=t5_cfg, scheduler_cfg=scheduler_cfg, tokenizer=tokenizer, device=device,
            attention_backend=resolve_attention_backend(attention_backend, device), model_dir=model_dir,
            t5_on_host=t5_on_host and t5_params is not None,
        )
        if lora_checkpoint is not None:
            pipe._merged_lora = (os.path.realpath(lora_checkpoint), float(lora_alpha))
        pipe.t5_on_mesh = text_encoder_device == "mesh" and t5_params is not None
        if mesh is not None:
            pipe.set_mesh(mesh)
        return pipe

    def load_lora(self, lora_checkpoint: Optional[str], lora_alpha: float = 64.0, cache_base: bool = True,
                  mode: str = "merge") -> None:
        """Swap the subject LoRA adapter without reloading the pipeline
        (``s2v_tpu/pipelines/s2v.py:339-452``).

        ``mode="merge"``: the base transformer weights (re-read from
        ``model_dir``, or the host copy kept by an earlier call with
        ``cache_base=True``) merged with the new adapter (``None``: the base
        weights), converted on the host (an int8 DiT stays int8), and moved
        to the device after the old tree is dropped, so two trees are never
        on the card at once.  A bad checkpoint raises before anything
        changes.

        ``mode="runtime"``: the base weights stay and the adapter's factors
        ride under ``transformer_params[RUNTIME_LORA_KEY]``; the DiT applies
        them per layer.  Factor trees are kept on the host for the last
        ``RUNTIME_LORA_CACHE_SIZE`` adapters, so re-selecting one costs one
        copy to the device.  The checkpoint is read before a merged adapter
        is unwound: a bad one leaves the pipeline as it was.  ``None``
        detaches the factors."""
        if mode not in ("merge", "runtime"):
            raise ValueError(f"lora mode must be 'merge' or 'runtime', got {mode!r}")
        if mode == "runtime":
            tree = self._resolve_runtime_lora(lora_checkpoint, lora_alpha)
            if self._merged_lora is not None:
                self.load_lora(None, cache_base=cache_base, mode="merge")
            self._attach_runtime_lora(tree)
            return
        self.set_runtime_lora(None)  # merge mode owns the kernels
        if lora_checkpoint is None and self._merged_lora is None:
            return  # the base weights are already in place

        base = self._base_transformer_sd
        if base is None:
            if not self.model_dir:
                raise ValueError("load_lora needs the source snapshot (pipeline was not built by "
                                 "from_pretrained); reload with from_pretrained")
            base = load_sharded_safetensors(os.path.join(self.model_dir, "transformer"))
            if self.transformer_cfg.disentangled_modulation:
                _add_base_linears(base, self.transformer_cfg.num_layers)
            if cache_base:
                self._base_transformer_sd = base
        sd = dict(base)
        if lora_checkpoint is not None:
            sd, _ = load_and_merge_lora(sd, lora_checkpoint, alpha=lora_alpha)
        host_params = convert_transformer_state_dict(sd, self.transformer_cfg,
                                                     quantize_int8=_has_int8(self.transformer_params))
        del sd
        self.transformer_params = None  # the old tree goes before the new one reaches the device
        if self._tp_specs is not None:  # each rank's model-dim slices, cut on the host
            from s2v_torch.parallel.sharding import shard_params, transformer_param_specs_like

            self._tp_specs = transformer_param_specs_like(host_params)
            self.transformer_params = shard_params(host_params, self.mesh, self._tp_specs, device=self.device)
        else:
            self.transformer_params = _to(host_params, self.device)
        self._merged_lora = (None if lora_checkpoint is None
                             else (os.path.realpath(lora_checkpoint), float(lora_alpha)))

    def set_runtime_lora(self, tree: Optional[dict]) -> None:
        """Attach (or detach, ``None``) a runtime LoRA factor tree in the
        layout of ``loaders.lora.runtime_lora_tree`` (host or device
        tensors); ``load_lora(path, mode="runtime")`` is the checkpoint
        front end."""
        if tree is not None and self._merged_lora is not None:
            raise ValueError(
                "a merged LoRA adapter is folded into the base kernels; runtime factors would stack on top of it "
                "— reset with load_lora(None) first, or use load_lora(path, mode='runtime') which unwinds the "
                "merge automatically")
        self._attach_runtime_lora(None if tree is None else self._place_runtime_tree(tree))

    def _place_runtime_tree(self, tree: dict) -> dict:
        return _tree_map(lambda t: t.to(self.device, self.transformer_cfg.dtype), tree)

    def _resolve_runtime_lora(self, lora_checkpoint: Optional[str], lora_alpha: float) -> Optional[dict]:
        """The placed factor tree of a checkpoint (host cache hit or a read),
        without touching the pipeline's weights."""
        if lora_checkpoint is None:
            return None
        key = (os.path.realpath(lora_checkpoint), float(lora_alpha))
        host = self._runtime_lora_cache.pop(key, None)
        if host is None:
            host = load_runtime_lora(lora_checkpoint, self.transformer_cfg.num_layers, alpha=lora_alpha)
            while len(self._runtime_lora_cache) >= RUNTIME_LORA_CACHE_SIZE:
                self._runtime_lora_cache.pop(next(iter(self._runtime_lora_cache)))
        self._runtime_lora_cache[key] = host  # (re-)inserted last: most recently used
        return self._place_runtime_tree(host)

    def _attach_runtime_lora(self, tree: Optional[dict]) -> None:
        if tree is None:
            self.transformer_params.pop(RUNTIME_LORA_KEY, None)
        else:
            self.transformer_params[RUNTIME_LORA_KEY] = tree

    def save_pretrained(self, out_dir: str, dtype: Optional[str] = None, write: bool = True) -> Optional[str]:
        """Write the current weights (a merged adapter included) as a
        diffusers-layout snapshot that ``from_pretrained`` loads, here or in
        the JAX package (``s2v_tpu/pipelines/s2v.py:527``).  ``dtype``: the
        on-disk dtype (``"bfloat16"`` halves the 5b snapshot); None keeps
        fp32.  Refuses while a runtime adapter is attached.  On a mesh
        whose model dim sliced the params every rank calls it (the slices
        are gathered) and only the ranks with ``write`` write; elsewhere a
        call with ``write=False`` does nothing."""
        from s2v_torch.loaders.export_hf import save_pipeline_snapshot

        if RUNTIME_LORA_KEY in self.transformer_params:
            raise ValueError(
                "save_pretrained with a runtime LoRA attached would export only the base weights; reload the "
                "adapter with load_lora(path, mode='merge') to export fused weights, or set_runtime_lora(None) "
                "to export the base model")
        if self._tp_specs is None:
            return save_pipeline_snapshot(self, out_dir, dtype=dtype) if write else None
        # every rank gathers its model-dim slices back; the caller picks who writes
        sliced = (self.transformer_params, self.t5_params)
        self.transformer_params, self.t5_params = self._whole_params()
        try:
            return save_pipeline_snapshot(self, out_dir, dtype=dtype) if write else None
        finally:
            self.transformer_params, self.t5_params = sliced

    def set_attention(self, backend: str, window: Optional[int] = None) -> None:
        """Set the attention backend (``auto`` resolves on this device) and,
        for the windowed family, the window half-width in latent frames
        (``s2v_tpu/pipelines/s2v.py:142-158``)."""
        backend = resolve_attention_backend(backend, self.device)
        if backend in FRAME_BACKENDS:
            self.transformer_cfg.require_frame_patches(f"the {backend!r} attention backend")
        self.attention_backend = backend
        if backend in WINDOWED_BACKENDS and window is not None:
            self.transformer_cfg = replace(self.transformer_cfg, attention_window_frames=window)

    def set_mesh(self, mesh, shard_now: bool = True) -> None:
        """Attach a mesh: a spec (``"dp2,tp4"``, ``"sp4"``), a dict of sizes
        (``{"data": 2, "model": 4}``), a
        ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
        ``data``, ``seq`` and ``model``, or None (back to one card)
        (``s2v_tpu/pipelines/s2v.py:78-125``).  A spec or dict makes the mesh
        over the default process group (``parallel/sharding.py::make_mesh``,
        which starts the group when there is none).

        With a ``model`` dim (of any size) the transformer params, bf16 or
        int8, are sliced in place for megatron TP, and T5's too when it runs
        on the mesh; every other leaf, and an attached runtime factor tree,
        stays whole on every rank.  ``shard_now=False`` attaches the mesh and
        leaves the params as they are (the trainer's ``--fsdp_base`` places
        them itself).  Slices of an earlier mesh are gathered back first, so
        ``set_mesh(None)`` restores the whole tree.  The runtime-LoRA cache
        goes stale and is cleared."""
        if mesh is not None and self.transformer_cfg is not None:  # a decode-only pipeline has no DiT
            self.transformer_cfg.require_frame_patches("a mesh")
        if isinstance(mesh, (str, dict)):
            from s2v_torch.parallel.sharding import make_mesh

            mesh = make_mesh(mesh, self.device.type)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the pipeline on {self.device.type}")
        if self._tp_specs is not None:
            self.transformer_params, self.t5_params = self._whole_params()
            self._tp_specs = self._t5_specs = None
            self._prompt_embed_cache.clear()
        self.mesh = mesh
        self._runtime_lora_cache.clear()
        if mesh is None or not shard_now or "model" not in (mesh.mesh_dim_names or ()):
            return
        from s2v_torch.parallel.sharding import shard_params, t5_param_specs, transformer_param_specs_like

        self._tp_specs = transformer_param_specs_like(self.transformer_params)
        self.transformer_params = shard_params(self.transformer_params, mesh, self._tp_specs)
        if self.t5_on_mesh and self.t5_params is not None:
            self._t5_specs = t5_param_specs(self.t5_params)
            self.t5_params = shard_params(self.t5_params, mesh, self._t5_specs)
            self._prompt_embed_cache.clear()

    def _whole_params(self):
        """(transformer, T5) params gathered back from the mesh's model-dim slices."""
        from s2v_torch.parallel.sharding import gather_params

        transformer = gather_params(self.transformer_params, self.mesh, self._tp_specs)
        t5 = self.t5_params
        if self._t5_specs is not None:
            t5 = gather_params(t5, self.mesh, self._t5_specs)
        return transformer, t5

    def _mesh_ctx(self):
        """The mesh context the denoise loop runs under (``s2v_tpu/pipelines/s2v.py:127-134``)."""
        if self.mesh is None:
            return nullcontext()
        return mesh_context(self.mesh, default_logical_map(self.mesh))

    def _seq_ring(self) -> int:
        """Ranks of the mesh's ``seq`` dim (1 without one) (``:136-140``)."""
        return self._mesh_size("seq")

    def _mesh_size(self, dim: str) -> int:
        from s2v_torch.parallel.sharding import mesh_sizes

        return mesh_sizes(self.mesh).get(dim, 1)

    def _resolve_tiling(self, height_px: int, width_px: int) -> bool:
        if self.vae_tiling == "auto":
            return height_px > self.vae_cfg.sample_height or width_px > self.vae_cfg.sample_width
        return bool(self.vae_tiling)

    @contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            with phase("s2v.sync.stage_timer"):
                torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0

    def _step_timer(self) -> "_StepTimer":
        """A denoise step callback that marks each step boundary; its
        ``finish()`` after the loop fills a new ``timings["denoise_step_s"]``
        with the device seconds between step boundaries (on the card CUDA
        events and one sync after the loop; on the CPU the host clock)."""
        times = self.timings["denoise_step_s"] = []
        return _StepTimer(self.device, times)

    def _to_device(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """An input on the card in ``dtype``; from the host a copy that waits for it."""
        with phase("s2v.sync.to_device"):
            return x.to(self.device, dtype)

    def _decode_timed(self, latents: torch.Tensor) -> np.ndarray:
        """:meth:`decode_latents` with its seconds in ``timings["decode_s"]``."""
        with phase("s2v.decode", log=True), self._timed("decode_s"):
            return self.decode_latents(latents)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def encode_prompt(
        self,
        prompt: Union[str, list],
        negative_prompt: Union[str, list, None] = None,
        max_sequence_length: Optional[int] = None,
        do_cfg: bool = True,
    ) -> torch.Tensor:
        """-> ``[2B (uncond | cond), T, d_model]`` (``[B, ...]`` without CFG);
        the negative prompt defaults to ""."""
        if self.t5_params is None or self.tokenizer is None:
            raise ValueError("pipeline built without a text encoder/tokenizer; pass prompt_embeds")
        if max_sequence_length is None:
            max_sequence_length = self.transformer_cfg.max_text_seq_length
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        cond = self._encode_texts(prompts, max_sequence_length)
        if not do_cfg:
            return cond
        neg = negative_prompt if negative_prompt is not None else ""
        negs = [neg] * len(prompts) if isinstance(neg, str) else list(neg)
        return torch.cat([self._encode_texts(negs, max_sequence_length), cond], dim=0)

    def _encode_texts(self, texts: list, max_length: int) -> torch.Tensor:
        """T5-encode with a per-text embedding cache (FIFO, at most
        ``PROMPT_CACHE_SIZE`` entries; never evicts what this call needs)."""
        missing = list(dict.fromkeys(t for t in texts if (t, max_length) not in self._prompt_embed_cache))
        if missing:
            t5_device = torch.device("cpu") if self.t5_on_host else self.device
            ids = torch.as_tensor(self.tokenizer.encode(missing, max_length), device=t5_device)
            if self.t5_on_mesh and self.mesh is not None:
                # on the mesh: sliced over its model dim (t5_param_specs), one all-reduce per o and wo
                from s2v_torch.parallel.context import tensor_parallel

                with self._mesh_ctx():
                    emb = t5_encode(self.t5_params, self.t5_cfg, ids, tp=tensor_parallel())
            else:
                emb = t5_encode(self.t5_params, self.t5_cfg, ids).to(self.device)
            needed = {(t, max_length) for t in texts}
            for key in list(self._prompt_embed_cache):
                if len(self._prompt_embed_cache) + len(missing) <= PROMPT_CACHE_SIZE:
                    break
                if key not in needed:
                    self._prompt_embed_cache.pop(key)
            for t, e in zip(missing, emb):
                self._prompt_embed_cache[(t, max_length)] = e
        return torch.stack([self._prompt_embed_cache[(t, max_length)] for t in texts], dim=0)

    def encode_ref_image(self, image, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """An image path, or an ``[H, W, 3]`` image in [-1, 1] -> scaled ref
        latents ``[1, 1, h, w, C]``: a posterior sample (noise from the CPU
        ``generator``) or, without a generator, the posterior mean.  With the
        VAE's ``invert_scale_latents`` (CogVideoX1.5) the latents are divided
        by the scaling factor instead of multiplied, the rule of diffusers'
        ``CogVideoXImageToVideoPipeline.prepare_latents`` for image latents."""
        if isinstance(image, str):
            image = load_image(image)
        x = torch.as_tensor(np.asarray(image, np.float32))[None, None]
        draw = None
        if generator is not None:
            draw = lambda shape: torch.randn(shape, generator=generator, dtype=torch.float32)  # noqa: E731
        sf = self.vae_cfg.scaling_factor
        return self.encode_pixels(x, draw, scale=1 / sf if self.vae_cfg.invert_scale_latents else sf)

    def encode_pixels(self, x, draw=None, use_tiling: Optional[bool] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
        """Frames ``[B, T, H, W, 3]`` in [-1, 1] -> scaled latents ``[B, F, h,
        w, C]``: a posterior sample whose noise is ``draw(shape)`` (a CPU fp32
        tensor), or without ``draw`` the posterior mean, times ``scale``
        (default: the VAE's scaling factor).  ``use_tiling`` None follows
        ``vae_tiling``."""
        x = torch.as_tensor(x).to(self.device, self.vae_cfg.dtype)
        if use_tiling is None:
            use_tiling = self._resolve_tiling(x.shape[2], x.shape[3])
        moments = vae_encode(self.vae_params, self.vae_cfg, x, use_tiling=use_tiling, use_slicing=self.vae_slicing)
        noise = None
        if draw is not None:
            noise = draw(tuple(moments.shape[:-1]) + (moments.shape[-1] // 2,)).to(self.device, moments.dtype)
        return gaussian_sample(moments, noise) * (self.vae_cfg.scaling_factor if scale is None else scale)

    def prepare_rope(self, height: int, width: int, num_latent_frames: int):
        """The fp32 (cos, sin) table over ``[text | ref | video]`` of a RoPE
        model, None for one without; with ``patch_size_t`` over the temporal
        patches of ``num_latent_frames`` (the padded count)."""
        cfg = self.transformer_cfg
        if not cfg.use_rotary_positional_embeddings:
            return None, None
        if cfg.patch_size_t is None:
            vc, vs, rc, rs = prepare_video_and_ref_rope(
                height, width, num_latent_frames, cfg.attention_head_dim, cfg.patch_size,
                self.vae_cfg.spatial_compression_ratio,
            )
        else:
            vc, vs, rc, rs = prepare_video_and_ref_rope_patches(
                height, width, num_latent_frames, cfg.attention_head_dim, cfg.patch_size, cfg.patch_size_t,
                (cfg.sample_height // cfg.patch_size, cfg.sample_width // cfg.patch_size),
                self.vae_cfg.spatial_compression_ratio,
            )
        return build_segmented_rope(cfg.max_text_seq_length, rc, rs, vc, vs, device=self.device)

    def prepare_pos_embedding(self, height: int, width: int, num_frames: int) -> Optional[torch.Tensor]:
        """The fp32 sincos table ``[text + video tokens, D]`` of a model
        without RoPE (the 2b family) for a clip of ``num_frames`` pixel
        frames at ``height`` x ``width``, as JAX's ``generate`` builds it
        (``s2v_tpu/pipelines/s2v.py:990-1003``); None for a RoPE model."""
        cfg = self.transformer_cfg
        if cfg.use_rotary_positional_embeddings:
            return None
        sc = self.vae_cfg.spatial_compression_ratio
        table = joint_text_video_pos_embedding(
            cfg.inner_dim, height // sc, width // sc, num_frames, cfg.patch_size,
            self.vae_cfg.temporal_compression_ratio, cfg.max_text_seq_length,
            cfg.spatial_interpolation_scale, cfg.temporal_interpolation_scale,
        )
        with phase("s2v.sync.to_device"):  # a copy from the host
            return torch.from_numpy(table).to(self.device)

    def check_frames(self, num_frames: int) -> None:
        """A model without RoPE has a positional table of ``sample_frames``
        frames at most (``s2v_tpu/pipelines/s2v.py:907``)."""
        cfg = self.transformer_cfg
        if num_frames > cfg.sample_frames and not cfg.use_rotary_positional_embeddings:
            raise ValueError(f"num_frames must be <= {cfg.sample_frames} (static positional embeddings)")

    @_on_card
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Latents ``[B, F, h, w, C]`` -> frames ``[B, T, H, W, 3]`` float32 in [0, 1].

        Resident serving keeps the DiT, T5 and adapters on the card, so the
        untiled decode may not fit (``s2v_tpu/pipelines/s2v.py:708-772``):
        with less than ``DECODE_UNTILED_MIN_FREE`` bytes free it decodes
        tiled, with less than ``DECODE_TILED_MIN_FREE`` in quarter-size tiles
        (:meth:`_decode_lean_tiles`).  A decode that runs out of memory is
        retried once in quarter-size tiles on the same card, and later
        decodes go there directly.

        On a ``seq`` ring above 1 the decode runs context-parallel on JAX's
        routes (``s2v_tpu/pipelines/s2v.py:647-700``): a tiled decode with a
        full tile for each rank spreads its tiles over the ring
        (``parallel/vae_spatial.py``); otherwise the frames
        (``parallel/vae_temporal.py``, untiled): uniform chunks when the ring
        divides the frames into chunks of the VAE's frame batch, else the
        reference's schedule when the ring has a rank for each of its
        uniform chunks, else the streaming decode on every rank."""
        z = latents.to(self.vae_cfg.dtype) / self.vae_cfg.scaling_factor
        sc = self.vae_cfg.spatial_compression_ratio
        tiled = self._resolve_tiling(z.shape[2] * sc, z.shape[3] * sc)
        log = get_logger("s2v_torch.pipeline")
        ring = self._seq_ring()
        if ring > 1:
            frames = None
            with phase("s2v.decode.vae"):
                if tiled:
                    from s2v_torch.parallel.vae_spatial import spatial_cp_supported, spatial_tiled_decode_cp

                    if spatial_cp_supported(self.vae_cfg, z, self.mesh, "seq"):
                        frames = spatial_tiled_decode_cp(self.vae_params, self.vae_cfg, z, self.mesh, "seq")
                if frames is None:
                    frames = self._decode_cp(z, ring, log)
            if frames is not None:
                return _frames_to_host(frames)
        if not self._decode_lean and not tiled:
            free = self._device_free_bytes()
            if free is not None and free < DECODE_UNTILED_MIN_FREE:
                lean = free < DECODE_TILED_MIN_FREE
                log.info("decode: %.1f GB free on the card with the serving stack resident — using %s instead of the "
                         "untiled decode", free / 2**30, "quarter-size tiles" if lean else "reference-style tiling")
                self._decode_lean = lean
                tiled = not lean
        if self._decode_lean:
            with phase("s2v.decode.vae"):
                frames = self._decode_lean_tiles(z)
            return _frames_to_host(frames)
        oom = False
        try:
            with phase("s2v.decode.vae"):
                frames = vae_decode(self.vae_params, self.vae_cfg, z, use_tiling=tiled, use_slicing=self.vae_slicing)
        except torch.cuda.OutOfMemoryError:
            oom = True  # retried below, once the exception no longer pins the failed call's tensors
        if oom:
            log.warning("VAE decode ran out of device memory with the serving stack resident — retrying with "
                        "quarter-size spatial tiles; later requests take that path directly")
            self._decode_lean = True
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            with phase("s2v.decode.vae"):
                frames = self._decode_lean_tiles(z)
        return _frames_to_host(frames)

    def _decode_cp(self, z: torch.Tensor, ring: int, log) -> Optional[torch.Tensor]:
        """The context-parallel decode of scaled latents, or None when the
        ring cannot take the canonical schedule (the streaming decode runs)."""
        from s2v_torch.parallel.vae_temporal import (
            canonical_cp_chunks,
            sharded_vae_decode,
            sharded_vae_decode_canonical,
        )

        t, fb = z.shape[1], self.vae_cfg.num_latent_frames_batch_size
        if t % ring == 0 and t // ring == fb:
            return sharded_vae_decode(self.vae_params, self.vae_cfg, z, self.mesh)
        n_cp = canonical_cp_chunks(self.vae_cfg, t)
        if 1 <= n_cp <= ring:
            return sharded_vae_decode_canonical(self.vae_params, self.vae_cfg, z, self.mesh)
        log.warning("seq mesh (ring=%d) cannot serve the canonical %d-chunk decode schedule for %d latent frames; "
                    "falling back to the single-device canonical streaming decode", ring, n_cp, t)
        return None

    def _device_free_bytes(self) -> Optional[int]:
        """Bytes the decode can still get on the card (free device memory
        plus what PyTorch's allocator holds unused); None on the CPU."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        return int(free + torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device))

    def _decode_lean_tiles(self, z: torch.Tensor) -> torch.Tensor:
        """The tiled decode at about quarter-size tiles: scaled latents in,
        ``[B, T, H, W, 3]`` in [-1, 1] out.

        Each latent tile side is half the VAE's (floor 8), rounded down to a
        multiple of 1 / overlap factor (6 high, 5 wide at the CogVideoX
        factors), at least one multiple, so that a tile's step and its
        blended crop are whole pixels and the tiles cover the frame exactly:
        at 480x720, 12 x 20 latent tiles.  The JAX package halves the sample
        size without that rounding (``s2v_tpu/pipelines/s2v.py:805-823``),
        which at 480x720 gives 15 x 22 tiles whose crops overrun their steps:
        a 496x760 frame (ROADMAP C.13)."""
        cfg, sc = self.vae_cfg, self.vae_cfg.spatial_compression_ratio

        def side(latent_tile: int, factor: float) -> int:
            m = round(1.0 / factor)
            return max(m * (max(latent_tile // 2, 8) // m), m)

        lean_cfg = replace(cfg, sample_height=2 * sc * side(cfg.tile_latent_min_height, cfg.tile_overlap_factor_height),
                           sample_width=2 * sc * side(cfg.tile_latent_min_width, cfg.tile_overlap_factor_width))
        return vae_decode(self.vae_params, lean_cfg, z, use_tiling=True, use_slicing=self.vae_slicing)

    def postprocess_video(self, video01: np.ndarray, output_type: str):
        """``np``: the float array ``[B, T, H, W, 3]`` in [0, 1]; ``pil``: per
        clip a list of PIL images; ``pt``: a CPU tensor ``[B, T, 3, H, W]``."""
        if output_type == "np":
            return video01
        if output_type == "pil":
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError("output_type='pil' needs the PIL package (Pillow), which is not installed") from e
            return [[Image.fromarray(f) for f in to_uint8_frames(clip)] for clip in video01]
        if output_type == "pt":
            return torch.from_numpy(np.ascontiguousarray(video01)).permute(0, 1, 4, 2, 3)
        raise ValueError(f"unknown output_type {output_type!r} ({' | '.join(OUTPUT_TYPES)})")

    # ------------------------------------------------------------------
    # end to end
    # ------------------------------------------------------------------

    @torch.inference_mode()
    @_on_card
    def generate(
        self,
        prompt: Optional[Union[str, list]] = None,
        ref_image=None,
        negative_prompt: Optional[str] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        use_dynamic_cfg: Optional[bool] = None,
        use_dpm: bool = False,
        num_videos_per_prompt: int = 1,
        seed: Optional[int] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        ref_latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
        cfg_mode: str = "auto",  # auto: batched, except a batch > 1 -> sequential
        adaptive_threshold: float = 0.0,  # > 0: opt-in step skipping
        cfg_skip_threshold: float = 0.0,  # > 0: skip the uncond forward once g - 1 < threshold
        segment_steps: int = 0,  # > 0: host-stepped segments of this many steps
        callback_on_segment_end=None,  # f(step, latents) -> None | False (stop) | new latents
        progress: bool = False,  # the per-step progress line on stderr
    ):
        """Generate a clip: ``[B, T, H, W, 3]`` float in [0, 1] (``np``), PIL
        frames (``pil``), ``[B, T, 3, H, W]`` (``pt``) or the final latents
        (``latent``); ``ref_image`` is a path or an ``[H, W, 3]`` array in
        [-1, 1].  The latents, the ref posterior noise and the DPM noise seed
        are drawn from CPU ``torch.Generator``s seeded from ``seed`` (the DPM
        draws from ``self.dpm_noise`` when it is set).  An argument left at
        None takes its value from ``self.pipeline_cfg``.

        ``segment_steps > 0`` runs the loop in segments of that many steps;
        after each, ``callback_on_segment_end(step, latents)`` may return
        False (or a 0-d bool tensor that is false) to stop, or a tensor of
        the latents' shape to replace them; anything else is ignored."""
        given = dict(height=height, width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
                     guidance_scale=guidance_scale, use_dynamic_cfg=use_dynamic_cfg, seed=seed)
        run = replace(self.pipeline_cfg, **{k: v for k, v in given.items() if v is not None})
        height, width, num_frames = run.height, run.width, run.num_frames
        num_inference_steps, guidance_scale = run.num_inference_steps, run.guidance_scale
        cfg = self.transformer_cfg
        backend, _ = route_seq_backend(resolve_attention_backend(self.attention_backend, self.device),
                                       cfg.num_attention_heads, self._seq_ring(), self._mesh_size("model"))

        self.check_frames(num_frames)
        sc_total = self.vae_cfg.spatial_compression_ratio * cfg.patch_size
        if height % sc_total or width % sc_total:
            raise ValueError(f"height/width must be divisible by {sc_total}")
        if prompt is None and prompt_embeds is None:
            raise ValueError("provide prompt or prompt_embeds")
        if prompt is not None and prompt_embeds is not None:
            raise ValueError("provide only one of prompt / prompt_embeds")
        if prompt is not None and not isinstance(prompt, (str, list)):
            raise ValueError(f"prompt must be str or list, got {type(prompt)}")
        if isinstance(prompt, list) and not all(isinstance(p, str) for p in prompt):
            raise ValueError("prompt list must contain only strings")
        if prompt_embeds is not None and negative_prompt is not None:
            raise ValueError(
                "negative_prompt is ignored when prompt_embeds is provided "
                "(pass [uncond | cond] rows in prompt_embeds instead)"
            )
        if ref_image is not None and ref_latents is not None:
            raise ValueError("provide only one of ref_image / ref_latents")
        if num_inference_steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        if num_frames < 1:
            raise ValueError("num_frames must be >= 1")
        if output_type not in OUTPUT_TYPES:
            raise ValueError(f"unknown output_type {output_type!r} ({' | '.join(OUTPUT_TYPES)})")
        if callback_on_segment_end is not None and segment_steps <= 0:
            raise ValueError("callback_on_segment_end needs segment_steps > 0 (the whole loop has no host hooks; "
                             "use progress=True for a step line)")

        self.timings = {}
        # a clip's host work before its first step; the benchmark weighs its device idle once a clip
        with phase("s2v.prologue", steps=num_inference_steps):
            seed_gen = torch.Generator().manual_seed(run.seed)
            seeds = torch.randint(2**62, (2,), generator=seed_gen)
            gen_latents = torch.Generator().manual_seed(int(seeds[0]))
            gen_ref = torch.Generator().manual_seed(int(seeds[1]))
            # drawn after the two above, so the latents and ref draws stay what they were
            dpm_seed = int(torch.randint(2**62, (1,), generator=seed_gen))

            do_cfg = guidance_scale > 1.0
            if prompt_embeds is None:
                with phase("s2v.encode_prompt"), self._timed("encode_prompt_s"):
                    prompt_embeds = self.encode_prompt(prompt, negative_prompt, do_cfg=do_cfg)
            prompt_embeds = self._to_device(prompt_embeds, cfg.dtype)
            if num_videos_per_prompt > 1:
                prompt_embeds = prompt_embeds.repeat_interleave(num_videos_per_prompt, dim=0)
            batch = prompt_embeds.shape[0] // (2 if do_cfg else 1)

            if ref_latents is None:
                if ref_image is None:
                    raise ValueError("need ref_image or ref_latents")
                with phase("s2v.encode_ref"), self._timed("encode_ref_s"):
                    ref_latents = self.encode_ref_image(ref_image, gen_ref)
            ref_latents = self._to_device(ref_latents, cfg.dtype)
            if ref_latents.shape[0] == 1 and batch > 1:
                ref_latents = ref_latents.expand(batch, *ref_latents.shape[1:])

            f_lat = run.latent_frames(self.vae_cfg.temporal_compression_ratio)
            h_lat, w_lat = run.latent_hw(self.vae_cfg.spatial_compression_ratio)
            # CogVideoX1.5: the latent frames padded to whole temporal patches, dropped before the decode
            pad_frames = -f_lat % (cfg.patch_size_t or 1)
            f_lat += pad_frames
            if latents is None:
                latents = torch.randn((batch, f_lat, h_lat, w_lat, cfg.in_channels), generator=gen_latents)
            elif latents.shape[1] != f_lat:
                raise ValueError(f"latents hold {latents.shape[1]} frames; {num_frames} frames take {f_lat} latent "
                                 f"frames ({pad_frames} of them padding)")
            latents = self._to_device(latents, cfg.dtype)
            patches, per_patch = token_grid(cfg, f_lat, h_lat, w_lat)
            ref_frames = ref_latents.shape[1]
            if cfg.patch_size_t is not None and ref_frames == 1:
                ref_frames = cfg.patch_size_t  # the DiT repeats it into one temporal patch
            tokens = {"tokens_text": prompt_embeds.shape[1],
                      "tokens_ref": token_grid(cfg, ref_frames, h_lat, w_lat)[0] * per_patch,
                      "tokens_video": patches * per_patch, "pad_frames": pad_frames}
            span_attrs(**tokens)

            with phase("s2v.prologue.rope"):
                rope_cos, rope_sin = self.prepare_rope(height, width, f_lat)
            with phase("s2v.prologue.pos_embedding"):
                pos_embedding = self.prepare_pos_embedding(height, width, num_frames)
            schedule = DenoiseSchedule.create(self.scheduler_cfg, num_inference_steps, guidance_scale,
                                              run.use_dynamic_cfg, use_dpm)
            if cfg_mode == "auto":
                cfg_mode = "sequential" if batch > 1 else "batched"
            log = get_logger("s2v_torch.pipeline")
            n_cfg_skip = int(cfg_skip_steps(schedule, cfg_skip_threshold).sum()) if do_cfg else 0
            if do_cfg and cfg_skip_threshold > 0.0:
                log.info("cfg-skip: uncond forward skipped on %d/%d steps", n_cfg_skip, num_inference_steps)
            noise = self.dpm_noise if self.dpm_noise is not None else DPMNoise(dpm_seed)
            adaptive = adaptive_threshold > 0.0

            timer = self._step_timer()
            # the whole loop is one segment: segments run the same step function, bit for bit
            run_steps = make_segmented_denoise(
                self.transformer_params, cfg, schedule, rope_cos, rope_sin, do_cfg=do_cfg, dpm_noise=noise,
                attention_backend=backend, cfg_mode=cfg_mode, cfg_skip_threshold=cfg_skip_threshold,
                adaptive_threshold=adaptive_threshold, progress=progress, step_callback=timer,
                pos_embedding=pos_embedding)
            carry = adaptive_init_carry(latents) if adaptive else (latents, torch.zeros_like(latents))
            segment = segment_steps if segment_steps > 0 else num_inference_steps
        with phase("s2v.denoise", log=True), self._mesh_ctx():
            for i0 in range(0, num_inference_steps, segment):
                i1 = min(i0 + segment, num_inference_steps)
                carry = run_steps(None, carry, ref_latents, prompt_embeds, None, i0, i1)
                if callback_on_segment_end is None:
                    continue
                with phase("s2v.callback"):  # the caller's code
                    cb = callback_on_segment_end(i1, carry[0])
                if isinstance(cb, (bool, np.bool_)) or (
                        getattr(cb, "shape", None) == () and getattr(cb, "dtype", None) in (torch.bool, np.bool_)):
                    with phase("s2v.sync.callback"):  # a device tensor's value
                        go_on = bool(cb)
                    if not go_on:
                        break  # cooperative interrupt (a 0-d bool tensor, e.g. torch.all(...), counts too)
                elif getattr(cb, "shape", None) == carry[0].shape:
                    # a same-shape tensor replaces the trajectory's latents
                    carry = (self._to_device(torch.as_tensor(cb), carry[0].dtype),) + tuple(carry[1:])
        timer.finish()
        final = carry[0]
        n_adaptive = carry[5] if adaptive else None
        if adaptive:
            log.info("adaptive denoise skipped %d/%d forwards", n_adaptive, num_inference_steps)
        self.stats = {"steps_run": len(self.timings["denoise_step_s"]), "cfg_skipped_steps": n_cfg_skip,
                      "adaptive_skipped_steps": n_adaptive, **tokens}
        if output_type == "latent":
            return final
        return self.postprocess_video(self._decode_timed(final[:, pad_frames:]), output_type)


class _StepTimer:
    """The denoise loop's step seconds.  Called after each step, it marks
    the boundary: on CUDA a timing event on the device's current stream,
    so the seconds are device seconds between step boundaries, resolved by
    ``finish()`` after the loop with one sync; on the CPU the host clock."""

    def __init__(self, device: torch.device, times: list):
        self.device, self.times = device, times
        self.marks = [self._mark()]

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def __call__(self, _i: int) -> None:
        self.marks.append(self._mark())

    def finish(self) -> None:
        if self.device.type == "cuda":
            with phase("s2v.sync.step_timer"):
                self.marks[-1].synchronize()
            self.times[:] = [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        else:
            self.times[:] = [b - a for a, b in zip(self.marks, self.marks[1:])]


def _frames_to_host(frames: torch.Tensor) -> np.ndarray:
    """Decoded ``[-1, 1]`` frames as ``[0, 1]`` float32 on the host: the copy
    (which waits for the decode) and the clip there."""
    with phase("s2v.decode.to_host"):
        return denormalize_video(frames.float().cpu().numpy())


def _add_base_linears(sd: dict, num_layers: int) -> None:
    """The pre-merge adaLN linears of the disentangled mode, added to a
    transformer state dict before any LoRA merge (``norm{1,2}.base_linear``
    beside ``norm{1,2}.linear``; ``s2v_tpu/pipelines/s2v.py:236-246``)."""
    for i in range(num_layers):
        for n in ("norm1", "norm2"):
            for wb in ("weight", "bias"):
                sd[f"transformer_blocks.{i}.{n}.base_linear.{wb}"] = sd[f"transformer_blocks.{i}.{n}.linear.{wb}"]


def _load_tokenizer(model_dir: str):
    """``tokenizer.json`` through ``tokenizers`` first, then the native
    sentencepiece tokenizer on ``tokenizer/spiece.model``, else None
    (``s2v_tpu/pipelines/s2v.py:296-310``)."""
    from s2v_torch.utils.sp_native import NativeSPTokenizer
    from s2v_torch.utils.tokenizer import T5CLSTokenizer

    if any(os.path.exists(os.path.join(model_dir, *p, "tokenizer.json")) for p in (("tokenizer",), ())):
        try:
            return T5CLSTokenizer.from_checkpoint_dir(model_dir)
        except ImportError:
            pass  # no `tokenizers` package: the native tokenizer reads spiece.model
    spiece = os.path.join(model_dir, "tokenizer", "spiece.model")
    return NativeSPTokenizer(spiece) if os.path.exists(spiece) else None
