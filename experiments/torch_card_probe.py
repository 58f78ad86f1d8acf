"""What the machine with the card offers a JPEG decoder: compilers, headers,
shared libraries and Python packages.  Prints one JSON object.

    python3 experiments/torch_card_probe.py

The port's face decoder (facialmmt_tpu_torch/native/) builds faceloader.cpp
with g++ against libjpeg and falls back to cv2; this says which of those
exist, and whether the CUDA toolkit's nvJPEG could stand in for both.
"""

import ctypes.util
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys


def _version(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
        return (out.stdout or out.stderr).strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _headers(name):
    roots = ["/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu",
             "/usr/local/cuda/include", "/usr/local/cuda/targets/x86_64-linux/include"]
    return [p for r in roots for p in glob.glob(os.path.join(r, name))]


def _libs(stem):
    roots = ["/usr/lib", "/usr/lib64", "/usr/lib/x86_64-linux-gnu", "/usr/local/lib",
             "/usr/local/cuda/lib64", "/usr/local/cuda/targets/x86_64-linux/lib"]
    return sorted(p for r in roots for p in glob.glob(os.path.join(r, stem + "*")))


def _compiles_against_libjpeg():
    """g++ builds and links a one-line libjpeg program."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    src = ("#include <cstdio>\n#include <jpeglib.h>\n"
           "int main(){jpeg_decompress_struct c; jpeg_error_mgr e;"
           "c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);"
           "jpeg_destroy_decompress(&c); return 0;}\n")
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"), "probe_jpeg")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "p.cpp"), "w") as f:
        f.write(src)
    r = subprocess.run([gxx, os.path.join(tmp, "p.cpp"), "-o",
                        os.path.join(tmp, "p"), "-ljpeg"],
                       capture_output=True, text=True, timeout=120)
    return r.returncode == 0 or r.stderr.strip()[-300:]


def main():
    found = {
        "python": sys.version.split()[0],
        "g++": _version(["g++", "--version"]),
        "nvcc": _version(["/usr/local/cuda/bin/nvcc", "--version"]),
        "jpeglib.h": _headers("jpeglib.h"),
        "libjpeg": _libs("libjpeg.so") + ([ctypes.util.find_library("jpeg")]
                                         if ctypes.util.find_library("jpeg") else []),
        "libturbojpeg": _libs("libturbojpeg.so"),
        "g++ -ljpeg": _compiles_against_libjpeg(),
        "nvjpeg.h": _headers("nvjpeg.h"),
        "libnvjpeg": _libs("libnvjpeg.so"),
        "packages": {m: importlib.util.find_spec(m) is not None
                     for m in ("cv2", "PIL", "torchvision", "transformers",
                               "safetensors", "yaml", "simplejpeg",
                               "turbojpeg", "imageio")},
    }
    try:
        import torch

        found["torch"] = torch.__version__
        found["torch_cuda"] = torch.version.cuda
    except ImportError:
        found["torch"] = None
    print(json.dumps(found))


if __name__ == "__main__":
    main()
