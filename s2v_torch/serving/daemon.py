"""Serving daemon: one process holds the loaded pipeline on the card and
serves generation requests over a unix-domain socket (counterpart of
``s2v_tpu/serving/daemon.py``, with its protocol).

A one-shot CLI run pays the load (and the LoRA merge) for every clip; the
daemon pays it once and a subject swap per adapter.

Protocol: newline-delimited JSON request/response pairs.

  {"op": "ping"}
  {"op": "stats"}
  {"op": "warmup",   ...generate-kwargs}            # a generate without export
  {"op": "generate", "prompt": ..., "ref_img_path": ...,
   "output_path": ..., ...generate-kwargs}
  # "prompt" may be a list of strings: one batched denoise, one mp4 per
  # prompt (output_path gets _0/_1/... suffixes), subject image shared
  {"op": "load_lora", "checkpoint_path": ..., "lora_alpha": 64,
   "lora_mode": "merge" | "runtime"}
  # swap the subject adapter (null checkpoint_path = base weights);
  # "runtime" keeps the base weights and attaches the low-rank factors
  # (cached adapters swap for one copy to the card).  generate/warmup also
  # take "lora_checkpoint" (+"lora_alpha", "lora_mode") inline: the daemon
  # swaps when it differs from the active adapter
  {"op": "shutdown"}

Responses: {"status": "ok", ...} | {"status": "error", "error": msg}; a
request that raises gets an error response and the daemon keeps serving.
Requests are served in order on one worker (one card); batching across
prompts is expressed inside a request (num_videos_per_prompt, prompt lists).

The port compiles nothing, so of the protocol's compile fields
``compiled`` is always false and ``compiled_configs`` /
``compiled_configs_kept`` always 0; they stay so that clients of the JAX
daemon parse the responses.  ``generate_latency_s`` covers every generate.
"""

from __future__ import annotations

import json
import os
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch

# generate() kwargs a request may override, with coercers
_GEN_KEYS = {
    "negative_prompt": str,
    "height": int,
    "width": int,
    "num_frames": int,
    "num_inference_steps": int,
    "guidance_scale": float,
    "use_dynamic_cfg": bool,
    "use_dpm": bool,
    "num_videos_per_prompt": int,
    "seed": int,
    "cfg_mode": str,
    "adaptive_threshold": float,
    "cfg_skip_threshold": float,
    "segment_steps": int,
}
# seconds a connected client may stay silent before the daemon drops it
CLIENT_IDLE_TIMEOUT_S = 30.0


class ServingDaemon:
    def __init__(self, pipe, socket_path: str, fps: int = 8, lora_checkpoint: Optional[str] = None,
                 lora_mode: str = "merge", lora_alpha: float = 64.0):
        self.pipe = pipe
        self.socket_path = socket_path
        self.fps = fps
        self.requests_served = 0
        self.clips_generated = 0
        # the active adapter (serve --checkpoint_path, then op load_lora), in stats
        self.lora_checkpoint = lora_checkpoint
        self.lora_alpha = float(lora_alpha)
        # the swap mode of requests that name none (never changed by a
        # request); lora_mode is the active adapter's
        self.default_lora_mode = lora_mode
        self.lora_mode = lora_mode
        self._latencies: list = []  # generate seconds
        self._t_start = time.time()

    # -- request handlers ------------------------------------------------

    def _gen_kwargs(self, req: dict) -> dict:
        return {k: coerce(req[k]) for k, coerce in _GEN_KEYS.items() if req.get(k) is not None}

    def handle(self, req: dict) -> dict:
        op = req.get("op", "generate")
        if op == "ping":
            return {"status": "ok", "pong": True}
        if op == "stats":
            lat = sorted(self._latencies)
            pct = lambda p: round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) if lat else None  # noqa: E731
            return {
                "status": "ok",
                "requests_served": self.requests_served,
                "clips_generated": self.clips_generated,
                "compiled_configs": 0,
                "lora_checkpoint": self.lora_checkpoint,
                "lora_mode": self.lora_mode,
                "uptime_s": round(time.time() - self._t_start, 1),
                "generate_latency_s": {"p50": pct(0.5), "p90": pct(0.9), "max": pct(1.0)},
            }
        if op == "load_lora":
            path = req.get("checkpoint_path")
            if path is not None and not os.path.exists(path):
                return {"status": "error", "error": f"checkpoint not found: {path}"}
            mode = str(req.get("lora_mode") or self.default_lora_mode)
            # an omitted alpha keeps the active one
            alpha = float(req.get("lora_alpha", self.lora_alpha))
            t0 = time.time()
            self.pipe.load_lora(path, lora_alpha=alpha, mode=mode)
            if self.pipe.device.type == "cuda":
                torch.cuda.synchronize(self.pipe.device)  # the swap's seconds include its copies to the card
            self.lora_checkpoint, self.lora_alpha, self.lora_mode = path, alpha, mode
            return {
                "status": "ok",
                "lora_checkpoint": path,  # None => base weights
                "lora_mode": mode,
                "seconds": round(time.time() - t0, 2),
                "compiled_configs_kept": 0,
            }
        if op == "shutdown":
            return {"status": "ok", "shutdown": True}
        if op in ("generate", "warmup"):
            return self._generate(req, export=op == "generate")
        return {"status": "error", "error": f"unknown op {op!r}"}

    def _generate(self, req: dict, export: bool) -> dict:
        from s2v_torch.utils.video import export_to_video

        swapped = False
        if "lora_checkpoint" in req:
            want = req["lora_checkpoint"]
            # an omitted lora_mode reuses the active adapter whatever its
            # mode, and a fresh swap takes the daemon's default
            req_mode = req.get("lora_mode")
            want_mode = str(req_mode or self.default_lora_mode)
            want_alpha = float(req.get("lora_alpha", self.lora_alpha))
            if want is not None and not os.path.exists(want):
                return {"status": "error", "error": f"checkpoint not found: {want}"}
            if (want != self.lora_checkpoint or want_alpha != self.lora_alpha
                    or (req_mode is not None and want_mode != self.lora_mode)):
                self.pipe.load_lora(want, lora_alpha=want_alpha, mode=want_mode)
                self.lora_checkpoint, self.lora_alpha, self.lora_mode = want, want_alpha, want_mode
                swapped = True

        kwargs = self._gen_kwargs(req)
        prompt = req.get("prompt")
        ref = req.get("ref_img_path")
        if export and (prompt is None or ref is None):
            return {"status": "error", "error": "generate needs prompt and ref_img_path"}
        if ref is not None and not os.path.exists(ref):
            return {"status": "error", "error": f"ref image not found: {ref}"}
        if not export and ref is None:
            # warmup without an image: zero ref latents at the request's latent geometry
            sc = self.pipe.vae_cfg.spatial_compression_ratio
            cfg = self.pipe.pipeline_cfg
            h = int(kwargs.get("height", cfg.height)) // sc
            w = int(kwargs.get("width", cfg.width)) // sc
            tcfg = self.pipe.transformer_cfg
            kwargs["ref_latents"] = torch.zeros((1, 1, h, w, tcfg.in_channels), dtype=tcfg.dtype,
                                                device=self.pipe.device)

        t0 = time.time()
        video = self.pipe.generate(prompt=prompt or "warmup", ref_image=ref, **kwargs)
        seconds = time.time() - t0
        if export:
            self._latencies = self._latencies[-999:] + [seconds]

        resp = {
            "status": "ok",
            "seconds": round(seconds, 2),
            "compiled": False,  # the port compiles nothing
            "shape": list(np.asarray(video).shape),
        }
        if swapped:
            resp["lora_checkpoint"] = self.lora_checkpoint
        if export:
            out_path = req.get("output_path") or os.path.join(req.get("output_dir", "."),
                                                               f"s2v_{int(time.time())}.mp4")
            outputs = []
            for clip in np.asarray(video):
                path = out_path if len(video) == 1 else os.path.splitext(out_path)[0] + f"_{len(outputs)}.mp4"
                outputs.append(export_to_video(clip, path, fps=int(req.get("fps", self.fps))))
            self.clips_generated += len(outputs)
            resp["outputs"] = outputs
        return resp

    # -- socket loop -----------------------------------------------------

    def serve_forever(self, ready_file: Optional[str] = None) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.socket_path)
        srv.listen(8)
        if ready_file:
            with open(ready_file, "w") as f:
                f.write("ready")
        try:
            shutdown = False
            while not shutdown:
                conn, _ = srv.accept()
                # an idle or dead client must not wedge the one worker: reads
                # between requests time out and the loop goes back to accept()
                conn.settimeout(CLIENT_IDLE_TIMEOUT_S)
                try:
                    with conn, conn.makefile("rwb") as stream:
                        for line in stream:
                            line = line.strip()
                            if not line:
                                continue
                            try:
                                resp = self.handle(json.loads(line))
                            except Exception as e:  # keep the daemon alive
                                resp = {"status": "error", "error": f"{type(e).__name__}: {e}",
                                        "traceback": traceback.format_exc(limit=8)}
                            self.requests_served += 1
                            stream.write((json.dumps(resp) + "\n").encode())
                            stream.flush()
                            if resp.get("shutdown"):
                                shutdown = True
                                break
                except OSError:
                    pass  # an idle (socket.timeout is an OSError) or dead client: drop it
        finally:
            srv.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
