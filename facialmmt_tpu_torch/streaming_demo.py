"""Streaming video -> emotion demo (counterpart of examples/streaming_demo.py).

Simulates a live multi-party conversation feed: each tick delivers one
utterance's face crops, audio and vision features and dialogue tokens, and an
EmotionServer(max_batch=4, face_capacity=32) on random weights from the
config's seed returns its emotion distribution.  Every request runs the same
static-shape pack, so the latency does not depend on the content.

Run:  python -m facialmmt_tpu_torch.streaming_demo [--ticks 10] [--tiny]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=10)
    p.add_argument("--tiny", action="store_true",
                   help="tiny config in float32 (CPU-friendly smoke run)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from facialmmt_tpu_torch.config import FacialMMTConfig
    from facialmmt_tpu_torch.serving import EmotionServer
    from facialmmt_tpu_torch.train.metrics import MELD_EMOTIONS

    cfg = FacialMMTConfig.tiny() if args.tiny else FacialMMTConfig()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    rng = np.random.default_rng(0)
    d = cfg.data

    t0 = time.perf_counter()
    server = EmotionServer(cfg, max_batch=4, face_capacity=32, dtype=dtype,
                           device=args.device)
    print(f"server warm in {time.perf_counter() - t0:.1f}s on "
          f"{server.device} (one all-padding pack before the stream starts)")

    latencies = []
    for tick in range(args.ticks):
        n_faces = int(rng.integers(1, 6))
        request = {
            "faces": rng.integers(0, 255, (n_faces, 160, 160, 3),
                                  dtype=np.uint8),
            "audio": rng.normal(size=(int(rng.integers(5, 20)),
                                      d.audio_feat_dim)),
            "vision": rng.normal(size=(n_faces, d.vision_feat_dim)),
            "input_ids": rng.integers(2, cfg.text.vocab_size, size=(40,)),
            "sep_mask": np.eye(40)[12],
        }
        t0 = time.perf_counter()
        probs = server.predict([request])[0]
        ms = (time.perf_counter() - t0) * 1000
        latencies.append(ms)
        top = int(np.argmax(probs))
        print(f"tick {tick:2d} | {n_faces} faces | {ms:7.1f} ms | "
              f"{MELD_EMOTIONS[top]:8s} {probs[top]:.2f}")

    arr = np.asarray(latencies[1:] or latencies)  # the first carries warm-up
    print(f"\nlatency p50 {np.percentile(arr, 50):.1f} ms | "
          f"p99 {np.percentile(arr, 99):.1f} ms | mean {arr.mean():.1f} ms")


if __name__ == "__main__":
    main()
