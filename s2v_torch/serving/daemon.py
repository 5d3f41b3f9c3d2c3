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

Across cards (``serve.py --mesh dp<a>,tp<b>,sp<c>`` under ``torchrun``): every rank
holds the pipeline and runs every request, since each generate runs on all
of them.  Rank 0 owns the socket: it hands each request (a ``load_lora``
swap and ``shutdown`` too) to the other ranks with ``broadcast_object_list``
over a gloo control group before it runs it, and it alone answers and
writes clips; the other ranks wait in :meth:`ServingDaemon.follow`.  Rank 0
answers once every rank has reported how its run ended: a request that
failed the same way on every rank gets its error and the ranks serve on,
while ranks that failed differently (one rank out of memory, a collective
that timed out) may have left their collectives out of step, so every rank
raises :class:`RanksOutOfStep` and exits, and ``torchrun`` ends the job.
This stands in for JAX's single controller, which drives every chip from one
process.

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
import torch.distributed as dist

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


class RanksOutOfStep(RuntimeError):
    """The ranks of a mesh daemon failed a request in different ways."""


class ServingDaemon:
    def __init__(self, pipe, socket_path: str, fps: int = 8, lora_checkpoint: Optional[str] = None,
                 lora_mode: str = "merge", lora_alpha: float = 64.0, control_group=None):
        self.pipe = pipe
        # the ranks of a mesh, to which rank 0 hands each request (None: one process)
        self.control_group = control_group
        self.is_main = control_group is None or dist.get_rank(control_group) == 0
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
        if export and self.is_main:
            out_path = req.get("output_path") or os.path.join(req.get("output_dir", "."),
                                                               f"s2v_{int(time.time())}.mp4")
            outputs = []
            for clip in np.asarray(video):
                path = out_path if len(video) == 1 else os.path.splitext(out_path)[0] + f"_{len(outputs)}.mp4"
                outputs.append(export_to_video(clip, path, fps=int(req.get("fps", self.fps))))
            self.clips_generated += len(outputs)
            resp["outputs"] = outputs
        return resp

    # -- across ranks ----------------------------------------------------

    def dispatch(self, req: dict) -> dict:
        """Hand the request to the other ranks (when there are any), then run it."""
        if self.control_group is None:
            return self.handle(req)
        dist.broadcast_object_list([req], src=dist.get_global_rank(self.control_group, 0), group=self.control_group)
        return self._run_on_every_rank(req)

    def _run_on_every_rank(self, req: dict) -> dict:
        """Run the request, then gather every rank's outcome before rank 0
        answers.  All ok: the response.  The same error on every rank (a bad
        request): that error, and the ranks serve on.  Anything else:
        :class:`RanksOutOfStep` on every rank."""
        error, resp = None, None
        try:
            resp = self.handle(req)
        except Exception as e:
            error = e
        outcomes = [None] * dist.get_world_size(self.control_group)
        dist.all_gather_object(outcomes, None if error is None else f"{type(error).__name__}: {error}",
                               group=self.control_group)
        if all(o is None for o in outcomes):
            return resp
        if all(o == outcomes[0] for o in outcomes):
            raise error
        raise RanksOutOfStep("the ranks failed this request differently, so their collectives may no longer "
                             "match; the daemon stops on every rank (" +
                             "; ".join(f"rank {r}: {o or 'ok'}" for r, o in enumerate(outcomes)) + ")") from error

    def follow(self) -> None:
        """The loop of a rank other than 0: run each request rank 0 hands
        over, until a shutdown; :class:`RanksOutOfStep` ends it."""
        src = dist.get_global_rank(self.control_group, 0)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=src, group=self.control_group)
            req = box[0]
            try:
                self._run_on_every_rank(req)
            except RanksOutOfStep:
                raise
            except Exception:  # every rank met this error; rank 0 answered it
                pass
            if req.get("op") == "shutdown":
                return

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
                            fatal = None
                            try:
                                resp = self.dispatch(json.loads(line))
                            except Exception as e:  # keep the daemon alive
                                resp = {"status": "error", "error": f"{type(e).__name__}: {e}",
                                        "traceback": traceback.format_exc(limit=8)}
                                fatal = e if isinstance(e, RanksOutOfStep) else None
                            self.requests_served += 1
                            stream.write((json.dumps(resp) + "\n").encode())
                            stream.flush()
                            if fatal is not None:
                                raise fatal
                            if resp.get("shutdown"):
                                shutdown = True
                                break
                except OSError:
                    pass  # an idle (socket.timeout is an OSError) or dead client: drop it
        finally:
            srv.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
