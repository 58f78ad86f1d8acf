"""From-files measurements of the port at FacialMMTConfig() width.  Needs
one NVIDIA GPU:

    python3 experiments/torch_file_steps.py [OUT.json]

1. The command line's eval at MELD's test-split size: 2,610 utterances (290
   dialogues of 9) in tests/fixtures.py's layout, 1-16 faces an utterance
   (mean 8.5, the "about 8 faces per utterance" of the trainer's face
   capacity; MELD's own counts are not in the repository), a released pair
   from seeded weights.  `--choice_modality T+A+V --doEval 1` runs twice in
   this process: plain (the whole call and its eval loop, the first batch,
   utterances/s) and with the eval loop under torch.profiler (the device's
   share of the loop).  Beside them the decoder's faces/s over every face of
   the split.
2. Does decoding JPEGs under the PrefetchLoader stay hidden behind the
   device, or does it set the pace?  One Trainer's model and optimizers take
   auxiliary steps of 150 Aff-Wild2 frames and target steps of 4 MELD
   utterances (one 64-face bucket), the batches coming from files
   (tests/fixtures.py's layout, decoded by whatever facialmmt_tpu_torch.native
   picks on the machine) or from the in-memory synthetic datasets with the
   same shapes and face counts, in turns: memory, files, files, memory, each
   STEPS steps after one warm-up step.  For every step the host clock reads
   the wait for the loader's batch (from asking for it to having it) and the
   step itself (to the device, augment, forward, backward, optimizer; it ends
   in a synchronize).  Prints the medians per source, and each batch's decode
   alone.

The fixtures' JPEGs are uniform noise (15-30 KB each); every image here is
re-encoded as a smooth one of a few KB (smooth_jpegs), nearer the entropy of
real face crops, so that decoding costs what real files would.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from facialmmt_tpu_torch import main as cli  # noqa: E402
from facialmmt_tpu_torch import native  # noqa: E402
from facialmmt_tpu_torch.config import FacialMMTConfig  # noqa: E402
from facialmmt_tpu_torch.data.affwild2 import AffwildDataset  # noqa: E402
from facialmmt_tpu_torch.data.image_pipeline import \
    affwild2_train_augment  # noqa: E402
from facialmmt_tpu_torch.data.loader import PrefetchLoader  # noqa: E402
from facialmmt_tpu_torch.data.meld import (MeldMultimodalDataset,  # noqa: E402
                                           SyntheticFerDataset,
                                           SyntheticMeldDataset)
from facialmmt_tpu_torch.ops import kernels  # noqa: E402
from facialmmt_tpu_torch.train.trainer import Trainer  # noqa: E402

STEPS = 8
AUX, TRG = 150, 4
TEST_SPLIT = {"test": (290, 9)}    # MELD's 2,610 test utterances
TEST_FACES = 16


def smooth_jpegs(paths):
    """Re-encode each JPEG as a Gaussian blur (sigma 4) of itself stretched
    to the full range, at quality 90; the mean size in bytes after."""
    import cv2

    size = 0
    for p in paths:
        img = cv2.GaussianBlur(cv2.imread(p), (0, 0), 4)
        cv2.imwrite(p, cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        size += os.path.getsize(p)
    return size / max(len(paths), 1)


def all_face_paths(ds):
    return [p for name in sorted(ds.utt_face_path)
            for p in ds.utt_face_path[name]]


def eval_rate(root, gpu):
    """Part 1: the command line's eval at MELD's test-split size."""
    meld = os.path.join(root, "meld")
    argv = chip_smoke.cli_argv(root, "--choice_modality", "T+A+V",
                               "--doEval", "1", "--deterministic_gumbel", "1")
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    t0 = time.perf_counter()
    chip_smoke.write_meld_layout(meld, cfg, TEST_SPLIT, TEST_FACES)
    ds = MeldMultimodalDataset(meld, "test", cli.text_arrays(cfg, "test"))
    paths = all_face_paths(ds)
    face_bytes = smooth_jpegs(paths)
    cfg = cli._adapt_static_shapes(cfg, ds)
    chip_smoke.write_released(torch, torch.device("cuda:0"), cfg,
                              os.path.join(root, "pretrained_model"))
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds._decode_faces(paths)
    decode = time.perf_counter() - t0
    f1, launches, plain = chip_smoke.cli_eval_timed(torch, argv)
    f1_prof, _, prof = chip_smoke.cli_eval_timed(torch, argv, profiled=True)
    if f1_prof != f1:
        raise AssertionError(f"W-F1 {f1} plain, {f1_prof} profiled")
    n = len(ds)
    r = {"utterances": n, "faces": len(paths),
         "face_jpeg_bytes_mean": face_bytes, "files_written_s": written,
         "wf1": f1, "launches": {k: v for k, v in launches.items() if v},
         "end_to_end_s": plain["total"], "loop_s": plain["loop"],
         "loop_loader_wait_s": plain["wait"],
         "first_batch_s": plain["first"],
         "utterances_per_s_end_to_end": n / plain["total"],
         "utterances_per_s_loop": n / plain["loop"],
         "profiled_loop_s": prof["loop"], "profiled_first_batch_s":
         prof["first"], "device_s": prof["device"],
         "device_share_of_profiled_loop": prof["device"] / prof["loop"],
         "decoder": native.decoder_name(), "decode_all_s": decode,
         "decoder_faces_per_s": len(paths) / decode}
    print(f"eval: {n} utterances, {len(paths)} faces (JPEGs of "
          f"{face_bytes:.0f} bytes on average): W-F1 {f1:.4f}; end to end "
          f"{plain['total']:.2f} s ({r['utterances_per_s_end_to_end']:.1f} "
          f"utterances/s: npz cache, released weights, eval); eval loop "
          f"{plain['loop']:.2f} s ({r['utterances_per_s_loop']:.1f} "
          f"utterances/s; {plain['wait']:.2f} s of it waiting for the "
          f"loader), first batch {plain['first'] * 1e3:.0f} ms; under "
          f"torch.profiler the loop {prof['loop']:.2f} s, device busy "
          f"{prof['device']:.2f} s "
          f"({100 * r['device_share_of_profiled_loop']:.1f} %); decoder "
          f"'{r['decoder']}' {r['decoder_faces_per_s']:.0f} faces/s (one "
          f"call over every face); launches {r['launches']} on {gpu}")
    return r


def timed_steps(loader, step):
    """(waits, steps) in ms for STEPS steps after one warm-up step."""
    waits, steps = [], []
    it = loader.epoch(1)
    for i in range(STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, _ = next(it)
        t1 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i:
            waits.append((t1 - t0) * 1e3)
            steps.append((t2 - t1) * 1e3)
    it.close()
    return waits, steps


def median_ms(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(out=""):
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    path, seconds = kernels.build()
    kernels.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    cfg = FacialMMTConfig()
    n_utts = TRG * (STEPS + 1)
    result = {"card": gpu, "decoder": native.decoder_name(),
              "steps": STEPS}
    with tempfile.TemporaryDirectory() as root:
        result["eval"] = eval_rate(root, gpu)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        chip_smoke.write_meld_layout(os.path.join(root, "meld"), cfg,
                                     {"train": (STEPS + 1, TRG)})
        aw = chip_smoke.fixtures().write_affwild_fixture(
            os.path.join(root, "affwild"), STEPS + 1, 220, seed=5)
        run_cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, data_load_path=os.path.join(root, "meld")))
        files = {
            "aux": AffwildDataset(aw["file_folder"], aw["anno_folder"]),
            "trg": MeldMultimodalDataset(
                os.path.join(root, "meld"), "train",
                cli.text_arrays(run_cfg, "train"))}
        if len(files["aux"]) < AUX * (STEPS + 1):
            raise AssertionError(f"{len(files['aux'])} Aff-Wild2 frames kept")
        result["frame_jpeg_bytes_mean"] = smooth_jpegs(
            [os.path.join(aw["file_folder"], p)
             for p, _ in files["aux"].data_list])
        result["face_jpeg_bytes_mean"] = smooth_jpegs(
            all_face_paths(files["trg"]))
        faces = [len(files["trg"].utt_face_path[f"dia{i // TRG}_utt{i % TRG}"])
                 for i in range(n_utts)]
        memory = {"aux": SyntheticFerDataset(AUX * (STEPS + 1), 112, seed=1),
                  "trg": SyntheticMeldDataset(cfg, n_utts, STEPS + 1, faces,
                                              seed=2)}

        trainer = Trainer(cfg)
        model = trainer._build_model()
        state, _, trg_bsz = trainer._init_multitask_state(
            model, memory["trg"], len(memory["aux"]))
        aux_step, trg_step, _, _ = trainer._make_steps(model)
        gen = trainer.generator

        def aux(batch):
            images, labels = batch
            x = affwild2_train_augment(gen, trainer._to_device(images).float(),
                                       img_size=cfg.data.swin_img_size)
            aux_step(state, x, trainer._to_device(labels), gen)

        def trg(batch):
            trg_step(state, trainer._prepare_faces(batch, train=True), gen)

        loaders = {
            "aux": lambda ds: PrefetchLoader(ds.get_batch, len(ds), AUX,
                                             shuffle=True, seed=3),
            "trg": lambda ds: trainer._target_loader(ds, trg_bsz, False)}
        steps = {"aux": aux, "trg": trg}
        for kind in ("aux", "trg"):
            runs = {"memory": ([], []), "files": ([], [])}
            for source in ("memory", "files", "files", "memory"):
                w, s = timed_steps(loaders[kind]({"memory": memory,
                                                  "files": files}[source]
                                                 [kind]), steps[kind])
                runs[source][0].extend(w)
                runs[source][1].extend(s)
            ds = files[kind]
            decode = median_ms(
                (lambda: ds.get_batch(range(AUX))) if kind == "aux" else
                (lambda: ds.get_batch(range(TRG), face_capacity=64)))
            result[kind] = {src: {"wait_ms": statistics.median(w),
                                  "step_ms": statistics.median(s),
                                  "wait_max_ms": max(w)}
                            for src, (w, s) in runs.items()}
            result[kind]["decode_batch_ms"] = decode
            r = result[kind]
            print(f"{kind}: from files wait {r['files']['wait_ms']:.2f} ms "
                  f"(max {r['files']['wait_max_ms']:.2f}), step "
                  f"{r['files']['step_ms']:.1f} ms; in memory wait "
                  f"{r['memory']['wait_ms']:.2f} ms (max "
                  f"{r['memory']['wait_max_ms']:.2f}), step "
                  f"{r['memory']['step_ms']:.1f} ms; medians of "
                  f"{2 * STEPS} steps each; one batch's decode alone "
                  f"{decode:.1f} ms ({result['decoder']}) on {gpu}")
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
