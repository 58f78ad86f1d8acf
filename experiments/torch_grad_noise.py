"""How far bf16 moves the auxiliary batch's gradients in the PyTorch port, and
whether the CUDA kernels add to it.  Needs one NVIDIA GPU:

    python3 experiments/torch_grad_noise.py

Swin-tiny FER at 224 px, random weights from the config's seed, 150 synthetic
images.  The gradients of the auxiliary loss are computed three ways from the
same weights and batch: the CUDA kernels under bf16 autocast, the kernels'
plain PyTorch versions under the same autocast on the card (the wrappers are
swapped for this experiment only), and the plain versions in fp32 on the CPU.
Printed, per group of leaves, the worst relative L2 and max-norm distance of
each pair, for the four combinations of {head ReLU kept, left out} x
{BatchNorm batch statistics, running statistics}, next to the distance of
Swin's output features.  chip_smoke.py's gradient check rests on the result:
with the ReLU all three differ from each other by a tenth to a fifth, without
it by one to three hundredths, least on running statistics.
"""

import copy
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facialmmt_tpu_torch.config import FacialMMTConfig, TextEncoderConfig  # noqa: E402
from facialmmt_tpu_torch.data.image_pipeline import affwild2_train_augment  # noqa: E402
from facialmmt_tpu_torch.data.meld import SyntheticFerDataset  # noqa: E402
from facialmmt_tpu_torch.ops.kernels import block_mlp, fused_block  # noqa: E402
from facialmmt_tpu_torch.train.steps import compute_context, cross_entropy  # noqa: E402
from facialmmt_tpu_torch.train.trainer import Trainer  # noqa: E402

IMAGES = 150
SWAPS = ((fused_block, "fused_attention_block_cuda", "fused_attention_block_plain"),
         (fused_block, "fused_attention_block_bwd_cuda",
          "fused_attention_block_bwd_plain"),
         (fused_block, "fused_attention_block_bwd_spill_cuda",
          "fused_attention_block_bwd_spill_plain"),
         (block_mlp, "fused_ln_mlp_residual_cuda", "fused_ln_mlp_residual_plain"),
         (block_mlp, "fused_ln_mlp_residual_bwd_cuda",
          "fused_ln_mlp_residual_bwd_plain"))
KERNELS = {(mod, name): getattr(mod, name) for mod, name, _ in SWAPS}
GROUPS = {"first block": "swin.layers.0.blocks.0.",
          "middle block": "swin.layers.2.blocks.3.",
          "last block": "swin.layers.3.blocks.1.",
          "head": ("swin.output_layer.", "linear.", "classifier.")}


def use_plain_versions(on: bool) -> None:
    for mod, name, plain in SWAPS:
        setattr(mod, name, getattr(mod, plain) if on else KERNELS[(mod, name)])


def gradients(net, images, labels, relu: bool, running: bool):
    """Gradients and Swin features of one batch; the BatchNorm's running
    statistics, which a batch-statistics forward updates, are put back."""
    buffers = {k: v.clone() for k, v in net.named_buffers()}
    net.train()
    net.zero_grad(set_to_none=True)
    with compute_context(images.device, "bfloat16"):
        feats = net.swin(images, keeps=[(None, None)] * 12,
                         use_running_average=running)
        hidden = net.linear(feats)
        logits = net.classifier(torch.relu(hidden) if relu else hidden)
    cross_entropy(logits, labels).backward()
    out = {k: p.grad.float().cpu() for k, p in net.named_parameters()}
    out["features"] = feats.detach().float().cpu()
    net.zero_grad(set_to_none=True)
    with torch.no_grad():
        for k, v in net.named_buffers():
            v.copy_(buffers[k])
    return out


def l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def linf(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    cfg = FacialMMTConfig().replace(text=TextEncoderConfig.tiny())
    model = Trainer(cfg)._build_model()
    raw, labels = SyntheticFerDataset(IMAGES, 112, cfg.num_labels,
                                      seed=1).get_batch(range(IMAGES))
    images = affwild2_train_augment(
        torch.Generator(dev).manual_seed(1),
        torch.from_numpy(raw).to(dev).float(), img_size=224)
    labels = torch.from_numpy(labels).to(dev)
    card = model.swin_model
    host = copy.deepcopy(card).to("cpu").float()
    for relu in (True, False):
        for running in (False, True):
            kernel = gradients(card, images, labels, relu, running)
            use_plain_versions(True)
            try:
                plain = gradients(card, images, labels, relu, running)
            finally:
                use_plain_versions(False)
            cpu = gradients(host, images.cpu(), labels.cpu(), relu, running)
            print(f"head ReLU {'kept' if relu else 'left out'}, BatchNorm on "
                  f"{'running' if running else 'batch'} statistics")
            print(f"  features |d|2/|f|2: kernel-cpu "
                  f"{l2(kernel['features'], cpu['features']):.4f}, plain-cpu "
                  f"{l2(plain['features'], cpu['features']):.4f}, kernel-plain "
                  f"{l2(kernel['features'], plain['features']):.4f}")
            top = max(float(v.abs().max()) for k, v in cpu.items()
                      if k != "features")
            for group, prefix in GROUPS.items():
                # leaves whose gradient is zero in exact arithmetic hold noise
                keys = [k for k in cpu if k.startswith(prefix)
                        and float(cpu[k].abs().max()) > 1e-3 * top]
                worst = lambda fn, a, b: max(fn(a[k], b[k]) for k in keys)
                print(f"  {group}: L2 kernel-cpu {worst(l2, kernel, cpu):.4f} "
                      f"plain-cpu {worst(l2, plain, cpu):.4f} kernel-plain "
                      f"{worst(l2, kernel, plain):.4f} | max kernel-cpu "
                      f"{worst(linf, kernel, cpu):.4f} plain-cpu "
                      f"{worst(linf, plain, cpu):.4f} kernel-plain "
                      f"{worst(linf, kernel, plain):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
