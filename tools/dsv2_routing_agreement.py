"""How often the port's expert routing agrees with the benchmark's plain
reference, layer by layer, for the DeepSeek-V2-Lite cell on one CUDA
device.

    python3 tools/dsv2_routing_agreement.py [--seed N] [--questions 1024]

Builds the cell's encoder (``benchmark/encoders/deepseek_v2.py``, weights
from ``--seed``), generates the configuration's questions from the same
seed, and embeds the first ``--questions`` of them, instructed, through
the port's trunk (``models/deepseek_v2.py::forward``) and through the
reference (``benchmark/reference/hotpot_dsv2.py::embed_texts``), keeping
each MoE layer's top-k choice of every real token. Prints, per layer, the
share of tokens whose expert sets are equal and the share of routed slots
the two share. The two differ only where float32 summation order moves a
router score across a neighbour's (the layers before feed the router
inputs that agree to about 1e-3).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
for p in (str(REPO), str(REPO / "benchmark")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "dsv2lite258k.batch_dense"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 99)
    ap.add_argument("--questions", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch

    from a_modular_rag_framework_torch.models import deepseek_v2 as dsv2
    from harness import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.find_cell(CELL)
    blk = cell.config["encoder"]
    enc, params = spec.load_module("encoders", blk["builder"]).build(
        blk, args.seed, "cuda")
    samples = spec.load_module("corpora", "hotpot_distractor").generate(
        cell.config["corpus"], int(cell.config["samples"]), args.seed)
    qs = [s["question"] for s in samples[:args.questions]]
    ids, lens = enc.host_featurize(qs)
    port = []
    with torch.no_grad():
        dsv2.forward(params, torch.from_numpy(ids).cuda(),
                     torch.from_numpy(lens).cuda(), enc.cfg, routes=port)
    plain = []
    spec.load_module("reference", cell.config["reference"]).embed_texts(
        params, [blk["query_instruction"] + q for q in qs], blk, "cuda",
        torch.bfloat16, block=len(qs), routes=plain)
    for layer, (a, b) in enumerate(zip(port, plain), start=1):
        same = float((a.sort(1).values == b.sort(1).values).all(1)
                     .float().mean())
        shared = sum(len(set(x) & set(y)) for x, y in
                     zip(a.tolist(), b.tolist())) / a.numel()
        print(f"MoE layer {layer}: {a.shape[0]} tokens, same expert set "
              f"{same:.5f}, slots shared {shared:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
