"""Where the dense top-k kernel's time goes: the kernel as built, against
copies of its source with parts taken out, on one CUDA device.

    python3 tools/profile_dense_topk.py [--out runs/profile_dense_topk.json]

Builds ``a_modular_rag_framework_torch/csrc/dense_topk.cu`` and two
variants with nvcc (in parallel, into ``_local/profile_dense_topk/``):

  - ``products_only``: the selection is skipped (the wgmma products and
    the TMA ring only; the results are wrong, the time is the floor of
    the present structure);
  - ``stages_4``: a 4-stage TMA ring instead of 3.

and times each (CUDA events, warm) at B 4096 and 256 x N 1,034,000 x d 64,
k 10 and 100, bf16 corpus of random normal rows, beside the bound of 3
bf16 tensor-core passes. Prints one line per case and a JSON summary with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SELECT = "    // selection from the accumulators."
STAGES = "constexpr int kStages = 3;"


def variants(src: str) -> dict:
    for marker in (SELECT, STAGES):
        if marker not in src:
            raise SystemExit(f"marker {marker!r} not in the kernel source")
    return {"kernel": src,
            "products_only": src.replace(SELECT, "    if (k > 0) continue;\n" + SELECT),
            "stages_4": src.replace(STAGES, "constexpr int kStages = 4;")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import torch

    from chip_smoke import bound_ms, cuda_ms
    from a_modular_rag_framework_torch.ops import _build
    from a_modular_rag_framework_torch.ops import topk as T

    if not torch.cuda.is_available():
        print("profile_dense_topk: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    src = (_build.CSRC / "dense_topk.cu").read_text(encoding="utf-8")
    out = REPO / "_local" / "profile_dense_topk"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        cu = out / f"{name}.cu"
        cu.write_text(text, encoding="utf-8")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dense_topk_launch.argtypes = [p, p] + [i] * 9 + [p] * 5
        lib.dense_topk_launch.restype = i
        lib.dense_topk_error_string.argtypes = [i]
        lib.dense_topk_error_string.restype = ctypes.c_char_p
        lib._bound = True
        libs[name] = lib

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    n = 1_034_000
    db = torch.randn((n, 64), generator=g, device=dev).to(torch.bfloat16)
    rows = []
    library = T._library
    try:
        for B, k in ((4096, 10), (4096, 100), (256, 10), (256, 100)):
            q = torch.randn((B, 64), generator=g, device=dev)
            bound, _ = bound_ms(B, n, 64, k, db.numel() * 2)
            row = {"B": B, "N": n, "d": 64, "k": k, "bound_ms": bound}
            for name, lib in libs.items():
                T._library = lambda lib=lib: (lib, {})
                row[f"{name}_ms"] = cuda_ms(lambda: T.dense_topk_cuda(q, db, k),
                                            5)
            rows.append(row)
            print(" ".join(f"{key} {val:.3f}" if isinstance(val, float)
                           else f"{key} {val}" for key, val in row.items())
                  + f" ({smi})", flush=True)
    finally:
        T._library = library
    summary = {"card": smi, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
