"""``python -m s2v_torch.serve`` — the serving daemon's entry point and its
client (counterpart of ``s2v_tpu/serve.py``).

Daemon: loads the pipeline once, on the CUDA card unless ``--device cpu``
(the model flags of the inference CLI), and serves requests on a unix
socket until a ``shutdown`` request; see ``s2v_torch/serving/daemon.py`` for
the protocol.

    python -m s2v_torch.serve --pretrained_model_name_or_path /path/to/snapshot \\
        --checkpoint_path /path/to/lora --socket /tmp/s2v_torch.sock --ready_file /tmp/s2v_ready

Client: send one JSON request and print the response; the exit code is 0
for ``"status": "ok"`` and 1 otherwise.

    python -m s2v_torch.serve --socket /tmp/s2v_torch.sock \\
        --request '{"op": "generate", "prompt": "...", "ref_img_path": "...", "output_path": "out.mp4"}'

Across cards: ``torchrun --nproc_per_node N -m s2v_torch.serve --mesh
dp<a>,tp<b>,sp<c> ...`` loads the pipeline on each card (the ``model`` dim's
slices of it, as the CLI does); rank 0 owns the socket and hands every
request to the other ranks, which run it with it (see
``serving/daemon.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import timedelta

from s2v_torch.cli_utils import (
    ATTENTION_BACKEND_CHOICES,
    BACKEND_NAMES,
    check_mesh_flags,
    str2bool as _str2bool,
    tiling_policy as _tiling_policy,
)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="s2v_torch serving daemon")
    p.add_argument("--socket", type=str, default="/tmp/s2v_torch.sock")
    p.add_argument("--request", type=str, default=None,
                   help="client mode: send this JSON request and print the response")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--checkpoint_path", type=str, default=None, help="S2V LoRA checkpoint dir")
    p.add_argument("--lora_alpha", type=float, default=64)
    p.add_argument("--lora_mode", type=str, default="merge", choices=["merge", "runtime"],
                   help="merge = fold adapters into the weights; runtime = keep the low-rank factors apart for "
                        "quick subject swaps")
    p.add_argument("--attention_backend", type=str, default="auto", choices=ATTENTION_BACKEND_CHOICES,
                   help="auto = the flash kernel on CUDA, plain attention on the CPU (the JAX names, as the CLI)")
    p.add_argument("--attention_window", type=int, default=2,
                   help="half-width (latent frames) for --attention_backend windowed")
    p.add_argument("--quantize_int8", action="store_true", default=False)
    p.add_argument("--text_encoder_device", type=str, default="auto", choices=["auto", "device", "host", "mesh"],
                   help="host keeps T5 on the CPU in fp32; mesh slices it over --mesh's model dim")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh over the processes torchrun started, one per card, e.g. dp2,tp2 or sp4")
    p.add_argument("--enable_tiling", type=_tiling_policy, default="auto")
    p.add_argument("--enable_slicing", type=_str2bool, default=True)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--ready_file", type=str, default=None,
                   help="written once the socket is listening (for supervisors)")
    p.add_argument("--warmup", type=str, default=None,
                   help="JSON generate-kwargs of a warmup request at start, e.g. "
                        '\'{"height": 480, "width": 720, "num_frames": 49}\'')
    p.add_argument("--compilation_cache_dir", type=str, default="auto",
                   help="accepted for the JAX daemon's command lines and ignored: the port compiles no XLA programs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(args=None):
    args = args or get_args()

    if args.request is not None:
        from s2v_torch.serving.client import request

        resp = request(args.socket, json.loads(args.request))
        print(json.dumps(resp, indent=2))
        return 0 if resp.get("status") == "ok" else 1

    check_mesh_flags(args)
    if not args.pretrained_model_name_or_path:
        print("daemon mode requires --pretrained_model_name_or_path", file=sys.stderr)
        return 2

    from s2v_torch.parallel.sharding import entry_point_mesh
    from s2v_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with entry_point_mesh(args.mesh, device.type) as mesh:
        return _serve(args, device, mesh)


# how long the other ranks of a mesh wait for the next request
IDLE_TIMEOUT = timedelta(days=365)


def _serve(args, device, mesh) -> int:
    import torch.distributed as dist

    from s2v_torch.pipelines.s2v import S2VPipeline
    from s2v_torch.serving.daemon import ServingDaemon
    from s2v_torch.utils.logging import get_logger

    log = get_logger("s2v_torch.serve")
    backend = BACKEND_NAMES[args.attention_backend]
    runtime_lora = args.lora_mode == "runtime"
    pipe = S2VPipeline.from_pretrained(
        os.path.expanduser(args.pretrained_model_name_or_path),
        lora_checkpoint=None if runtime_lora else args.checkpoint_path,
        lora_alpha=args.lora_alpha,
        attention_backend=backend,
        quantize_int8=args.quantize_int8,
        text_encoder_device=args.text_encoder_device,
        mesh=mesh,
        device=device,
    )
    if runtime_lora and args.checkpoint_path:
        pipe.load_lora(args.checkpoint_path, lora_alpha=args.lora_alpha, mode="runtime")
    pipe.vae_tiling = args.enable_tiling
    pipe.vae_slicing = bool(args.enable_slicing)
    pipe.set_attention(backend, args.attention_window)
    # requests reach the other ranks over gloo: an idle daemon must not time out its group
    control = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT) if mesh is not None else None
    daemon = ServingDaemon(pipe, args.socket, fps=args.fps, lora_checkpoint=args.checkpoint_path,
                           lora_mode=args.lora_mode, lora_alpha=args.lora_alpha, control_group=control)

    if args.warmup:
        wu = {"op": "warmup", **json.loads(args.warmup)}
        log.info("warmup: %s", wu)
        log.info("warmup done: %s", daemon.handle(wu))

    if not daemon.is_main:
        daemon.follow()
        return 0
    log.info("serving on %s", args.socket)
    daemon.serve_forever(ready_file=args.ready_file)
    log.info("daemon stopped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
