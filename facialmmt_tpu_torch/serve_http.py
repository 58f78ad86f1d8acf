"""JSON-over-HTTP front end for the port's serving stack (stdlib only;
counterpart of facialmmt_tpu/serve_http.py).

Request threads of a ThreadingHTTPServer submit to one shared
AsyncBatchServer (a bucket router when several buckets are given) and block
on their future: concurrency comes from the thread pool, batching from the
packer, and the device only ever sees the buckets' static shapes.

Endpoints:
  POST /predict  - body: JSON object with optional keys
                     "audio":   list[La][audio_feat_dim] floats
                     "vision":  list[Lv][vision_feat_dim] floats
                     "faces":   base64 of raw uint8 H*W*3 frames ("faces_shape"
                                [n, H, W, 3] required) OR a nested list
                     "input_ids", "sep_mask", "utt_in_dia_idx": token channel
                   reply: {"probs": [...], "label": int}
  GET  /healthz  - {"ok": true, "buckets": [[max_batch, face_capacity], ...]}
  GET  /stats    - packer telemetry {n_packs, mean_fill, bucket_counts}

Run: python -m facialmmt_tpu_torch.serve_http --port 8756 [--buckets 1,12 8,64]
[--checkpoint DIR] [--tiny] [--device cuda|cpu] (random weights from the
config's seed unless --checkpoint names a directory of best files).
"""

from __future__ import annotations

import base64
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _decode_request(payload: Dict[str, Any]) -> Dict[str, Any]:
    """JSON body -> the request dict EmotionServer.build_pack understands."""
    req: Dict[str, Any] = {}
    if "audio" in payload:
        req["audio"] = np.asarray(payload["audio"], np.float32)
    if "vision" in payload:
        req["vision"] = np.asarray(payload["vision"], np.float32)
    if "faces" in payload:
        faces = payload["faces"]
        if isinstance(faces, str):  # base64 raw uint8, shape alongside
            shape = tuple(payload["faces_shape"])
            buf = base64.b64decode(faces)
            req["faces"] = np.frombuffer(buf, np.uint8).reshape(shape)
        else:
            req["faces"] = np.asarray(faces, np.uint8)
    if "input_ids" in payload:
        req["input_ids"] = np.asarray(payload["input_ids"], np.int32)
        if "sep_mask" in payload:
            req["sep_mask"] = np.asarray(payload["sep_mask"], np.int32)
        req["utt_in_dia_idx"] = int(payload.get("utt_in_dia_idx", 0))
    return req


class ServingApp:
    """Owns the front end and translates HTTP bodies to packer requests."""

    def __init__(self, front) -> None:
        self.front = front  # AsyncBatchServer (single bucket or router)

    def predict(self, payload: Dict[str, Any],
                timeout_s: float = 60.0) -> Dict[str, Any]:
        probs = self.front.submit(_decode_request(payload)).result(
            timeout=timeout_s)
        return {"probs": [float(p) for p in probs],
                "label": int(np.argmax(probs))}

    def healthz(self) -> Dict[str, Any]:
        return {"ok": True,
                "buckets": [[s.max_batch, s.face_capacity]
                            for s in self.front.servers]}

    def stats(self) -> Dict[str, Any]:
        from facialmmt_tpu_torch.serving import bucket_counts

        fills = self.front.pack_sizes
        return {"n_packs": len(fills),
                "mean_fill": float(np.mean(fills)) if fills else 0.0,
                "bucket_counts": bucket_counts(self.front.bucket_choices)}


def make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._reply(200, app.healthz())
            elif self.path == "/stats":
                self._reply(200, app.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                code, obj = 200, app.predict(payload)
            except Exception as e:  # surface as a 400, keep serving
                code, obj = 400, {"error": f"{type(e).__name__}: {e}"}
            try:  # reply OUTSIDE the handler try: a client that hung up
                self._reply(code, obj)  # mid-write must not trigger a second
            except (BrokenPipeError, ConnectionResetError):  # status line
                pass

        def log_message(self, fmt, *args):  # quiet: telemetry via /stats
            pass

    return Handler


def serve(front, host: str = "127.0.0.1", port: int = 8756,
          block: bool = True) -> Tuple[ThreadingHTTPServer, ServingApp]:
    """Start the HTTP front over an AsyncBatchServer (port 0: the OS picks
    one, read it from `server.server_address`).  block=False runs the server
    on a daemon thread and returns (server, app); stop it with
    server.shutdown()."""
    app = ServingApp(front)
    httpd = ThreadingHTTPServer((host, port), make_handler(app))
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, app


def load_serving_state(checkpoint_dir: str) -> Dict[str, Any]:
    """The pipeline state_dict in the newest best file under
    `checkpoint_dir`: what Trainer.run_multimodal saves through
    checkpoint/io.py's CheckpointManager, the Swin head's BatchNorm running
    statistics among its buffers.  EmotionServer loads it strictly.  Raises
    FileNotFoundError when the directory holds no best file."""
    from facialmmt_tpu_torch.checkpoint.io import CheckpointManager

    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir}")
    _, state = CheckpointManager(checkpoint_dir).restore_best()
    return state


def _build_front(cfg, state_dict, buckets: Sequence[Tuple[int, int]],
                 batch_deadline_ms: float, device="cuda"):
    from facialmmt_tpu_torch.serving import AsyncBatchServer, EmotionServer

    servers = [EmotionServer(cfg, state_dict, max_batch=mb,
                             face_capacity=cap, device=device)
               for mb, cap in buckets]
    return AsyncBatchServer(servers if len(servers) > 1 else servers[0],
                            batch_deadline_ms=batch_deadline_ms)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.ops.kernels import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8756)
    ap.add_argument("--buckets", nargs="+", default=["1,12", "8,64"],
                    help="max_batch,face_capacity per bucket; several: a "
                         "router")
    ap.add_argument("--batch_deadline_ms", type=float, default=5.0)
    ap.add_argument("--checkpoint", default=None,
                    help="directory of a training run's best files (the "
                         "newest best_<epoch> is served; omitted: random "
                         "weights from the config's seed)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU-friendly smoke deployment)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = FacialMMTConfig.tiny() if args.tiny else FacialMMTConfig()
    state = load_serving_state(args.checkpoint) if args.checkpoint else None
    buckets = [tuple(int(x) for x in b.split(",")) for b in args.buckets]
    front = _build_front(cfg, state, buckets, args.batch_deadline_ms, device)
    print(f"serving on http://{args.host}:{args.port} buckets={buckets}",
          flush=True)
    serve(front, args.host, args.port, block=True)


if __name__ == "__main__":
    main()
