"""The one traffic generator: MELD-shaped serving requests and their arrival
times, from a workload's parameters and the run's seed.

Sizes (dialogue length, utterance position, tokens per utterance, audio
frames, faces) and the gaps between arrivals are drawn once from the
workload's fixed `shape_seed`, each quantity from a stream of its own: a set
of `cycle` sizes, and of the open loop's gaps, that every run seed gets in
an order of its own.  A count's entry names its distribution (`_count`),
its parameters and, under `source`, where they come from.  The open
loop's set is its window's requests, the gaps scaled so that they fill the
window exactly; a closed loop takes the set again and again, each time in
another order.  The run seed draws the orders, the token ids, the feature
values and the face pixels.  Features and faces are slices of pools drawn in
bulk, so a run of thousands of requests holds little host memory.

Dialogues follow the RoBERTa separator layout of the reference: <s> u0 </s>
</s> u1 </s> ... with sep_mask 1 on each utterance-final </s>, cut at
`max_tokens`."""

from __future__ import annotations

import numpy as np

BOS, PAD, EOS = 0, 1, 2


def _count(rng, d: dict, size) -> np.ndarray:
    """Counts of one quantity, cut at d["max"]: `poisson` is min +
    Poisson(mean - min); `exponential` is min + floor(Exponential(scale)),
    whose standard deviation is its scale."""
    if d["dist"] == "poisson":
        x = d["min"] + rng.poisson(d["mean"] - d["min"], size)
    elif d["dist"] == "exponential":
        x = d["min"] + np.floor(rng.exponential(d["scale"], size))
    else:
        raise ValueError(f"unknown distribution {d['dist']!r}")
    return np.minimum(x, d["max"]).astype(np.int64)


def _sizes(spec: dict, n: int) -> dict:
    stream = lambda k: np.random.default_rng([spec["shape_seed"], k])
    d = spec["utts_per_dialogue"]
    utts = _count(stream(0), d, n)
    toks = _count(stream(1), spec["tokens_per_utt"], (n, d["max"]))
    pos = (stream(2).random(n) * utts).astype(np.int64)
    audio = _count(stream(3), spec["audio_frames"], n)
    faces = _count(stream(4), spec["faces"], n)
    gaps = stream(5).exponential(1.0, n)
    return {"utts": utts, "toks": toks, "pos": pos, "audio": audio,
            "faces": faces, "gaps": gaps}


def dialogue(n_utts, tok_counts, ids, max_tokens):
    """(input_ids, sep_mask) of one dialogue, cut at max_tokens."""
    out, sep = [], []
    at = 0
    for u in range(n_utts):
        k = int(tok_counts[u])
        body = list(ids[at:at + k])
        at += k
        seg = ([BOS] if u == 0 else [EOS]) + body + [EOS]
        out += seg
        sep += [0] * (len(seg) - 1) + [1]
    return (np.asarray(out[:max_tokens], np.int32),
            np.asarray(sep[:max_tokens], np.int32))


class Traffic:
    """`count` requests of a workload under `seed`, from a set of `cycle`
    sizes (all of them by default): request(i) is the i-th request dict the
    program is sent; `due` the arrival times of an open loop whose window of
    `seconds` holds the first `cycle` requests (count / seconds per second)."""

    def __init__(self, spec: dict, cfg_tree: dict, seed: int, count: int,
                 seconds: float = 1.0, cycle: int | None = None):
        data = cfg_tree["data"]
        self.spec = spec
        self.count = count
        cycle = cycle or count
        sizes = _sizes(spec, cycle)
        rng = np.random.default_rng([seed % (2 ** 63), 7])
        order = np.concatenate([rng.permutation(cycle)
                                for _ in range(-(-count // cycle))])[:count]
        self.sizes = {k: v[order] for k, v in sizes.items()}
        gaps = self.sizes["gaps"][:cycle]
        due = np.concatenate([[0.0], np.cumsum(gaps[1:])])
        self.due = due / (due[-1] + gaps[0]) * seconds
        self.vocab = cfg_tree["text"]["vocab_size"]
        self.max_tokens = data["max_seq_length"]
        pool = spec["pool"]
        self.tokens = rng.integers(3, self.vocab, size=pool["tokens"],
                                   dtype=np.int32)
        self.audio_pool = rng.standard_normal(
            (pool["audio_rows"], data["audio_feat_dim"]), dtype=np.float32)
        self.vision_pool = rng.standard_normal(
            (pool["vision_rows"], data["vision_feat_dim"]), dtype=np.float32)
        face = spec["face_px"]
        self.face_pool = rng.integers(0, 256, size=(pool["faces"], face, face,
                                                    3), dtype=np.uint8)
        self.offsets = rng.integers(0, 2 ** 31, size=(count, 4))
        self.lv = data["vision_utt_max_len"]
        self.lt = data["text_utt_max_len"]

    def request(self, i: int) -> dict:
        s = self.sizes
        o = self.offsets[i]
        n_utts = int(s["utts"][i])
        toks = s["toks"][i]
        need = int(toks[:n_utts].sum())
        start = int(o[0] % (len(self.tokens) - need))
        ids, sep = dialogue(n_utts, toks, self.tokens[start:start + need],
                            self.max_tokens)
        la = int(s["audio"][i])
        nf = int(s["faces"][i])
        a0 = int(o[1] % (len(self.audio_pool) - la))
        v0 = int(o[2] % (len(self.vision_pool) - self.lv))
        f0 = int(o[3] % (len(self.face_pool) - nf))
        req = {"rid": i, "input_ids": ids, "sep_mask": sep,
               "utt_in_dia_idx": int(s["pos"][i]),
               "audio": self.audio_pool[a0:a0 + la]}
        if nf:
            req["vision"] = self.vision_pool[v0:v0 + nf]
            req["faces"] = self.face_pool[f0:f0 + nf]
        return req

    def work(self, i: int) -> dict:
        """The sizes the program computes on for request i (real tokens,
        frames and faces; no padding)."""
        s = self.sizes
        n_utts = int(s["utts"][i])
        toks = s["toks"][i]
        tokens = min(int(toks[:n_utts].sum()) + 2 * n_utts, self.max_tokens)
        return {"tokens": tokens, "audio": int(s["audio"][i]),
                "faces": min(int(s["faces"][i]), self.lv),
                "span": int(min(toks[int(s["pos"][i])], self.lt))}
