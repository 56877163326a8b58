"""One run of one benchmark cell of the PyTorch port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (``setup_s``, from process start):
the samples generated from the seed, the program's index built in memory
and uploaded, the engine warmed up on the window's own shapes. Then the
window: the cell's traffic (its mix's stream) through the program's entry
(its mix's entry) for ``--seconds``. With ``--trace 1`` the window runs
under ``torch.profiler`` and the run reports the cell's per-layer metrics
instead of its end-to-end ones; a cell with an end-to-end metric read
from the device trace has the card's ops traced in every run. After the
window the program's state is freed and the cell's judge compares a
sample of the answers with the plain reference (``correct``). Every piece is found by name
(``harness/spec.py``).

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each with its limit.
Without a CUDA device, or with fewer devices than the cell asks for, the
run prints no result and exits with code 3; a run that finds JAX or the
JAX package loaded after the window exits with code 4.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache of a run lives at a fixed path in the
# checkout; the program's own builds go to its csrc/build/
CACHE = BENCH / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one process with few threads: the host path is single-threaded Python
# and C++, and idle pools of compute threads only contend for the cores
# the card's host shares (on an H100: 6-16 % more hybrid q/s and steadier)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "a_modular_rag_framework_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


class RunInfo:
    """What a per-layer metric reader (``metrics/<name>.py``) and a judge
    (``judges/<name>.py``) read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None, controls=(), root=None):
    """(result dict, compared {name: (value, limit)}, notes, control
    readings {control: {name: value}}). ``fault`` (tests only) receives
    the window's results and may break them; ``controls`` names reference
    precisions to put in the program's place on the same sample
    (``benchmark/control.py``); ``root`` is the benchmark folder whose
    modules the run loads (this one by default)."""
    import torch

    from harness import check, deploy, spec
    from harness.trace import Spans, Window

    root = root or spec.BENCH

    def module(kind, name):
        return spec.load_module(kind, name, root)

    config, mix = cell.config, cell.traffic
    t_gen = time.time()
    samples = deploy.generate_samples(config, seed, root)
    t_build = time.time()
    dep = deploy.build(config, seed, device, samples, root)
    t_warm = time.time()
    questions = [s["question"] for s in samples]
    stream = module("streams", mix["stream"]).make(mix, len(questions), seed)
    entry = module("entries", mix["entry"])
    spans = Spans()
    entry.drive(dep.engine, questions, stream, mix, spans, 0.0,
                n_batches=int(mix["warmup_batches"]))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    spans.seconds.clear()
    setup_s = time.time() - t_start

    # an end-to-end metric read from the device trace: the card's ops are
    # traced in every run of the cell, its host ranges only with --trace 1
    device_e2e = any(m["source"] == "device_trace" for m in cell.end_to_end)
    with Window(cuda and (trace or device_e2e),
                device_only=not trace) as win:
        res = entry.drive(dep.engine, questions, stream, mix, spans, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = win.summary(getattr(entry, "GAP_SPANS", ()))
    n_rows = dep.index.n_docs
    dim = dep.index.embed_dim
    params = dep.encoder_params
    dep.close()
    del dep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if fault is not None:
        fault(res)

    # ---- correctness: the plain reference over a sample of answers ----
    t_ref = time.time()
    k = int(mix["top_k"])
    ctx = RunInfo(samples=samples, config=config, questions=questions,
                  results=res.results, k=k, device=device,
                  encoder_params=params, seed=seed,
                  ref=module("reference", config["reference"]),
                  sample=check.draw_sample(res.results,
                                           int(mix["check_questions"]),
                                           seed))
    judge = module("judges", cell.judge).make(ctx)
    numbers = judge()
    control_numbers = {c: judge(c) for c in controls}
    notes = []
    if getattr(ctx, "row_of", None) is not None:
        qual = check.quality(ctx.row_of, samples, res.results, ctx.sample, k)
        notes.append(f"quality over {len(ctx.sample)} sampled answers: "
                     f"recall@{k} {qual['recall_at_k']:.4f}, "
                     f"MRR {qual['mrr']:.4f}")
    notes.append(f"reference check {time.time() - t_ref:.1f} s")
    compared = {n: (float(v), cell.limits.get(n)) for n, v in
                numbers.items()}
    correct = bool(compared) and all(lim is not None and v <= lim
                                     for v, lim in compared.values())

    # ---- metrics ----
    values = {}
    enc = config.get("encoder")
    trunk_flops = (deploy.encoder_builder(enc, root).flops(int(mix["batch"]),
                                                           enc)
                   if enc is not None else 0.0)
    info = RunInfo(trace=summary, spans=dict(spans.seconds),
                   calls=res.calls, questions=res.questions,
                   window_s=res.seconds, batch=int(mix["batch"]),
                   n_rows=n_rows, dim=dim, top_k=k,
                   trunk_flops=trunk_flops)
    if trace:
        for m in cell.per_layer:
            v = module("metrics", m["name"]).read(info)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(res.values, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in e2e and m["source"] == "device_trace":
                # read from the device trace by ``metrics/<name>.py``; a
                # run off the card (the tests) has no trace to read
                v = module("metrics", m["name"]).read(info)
                if v is None and not cuda:
                    continue
                e2e[m["name"]] = v
            if e2e.get(m["name"]) is None:
                raise KeyError(f"the {mix['entry']} entry gives no "
                               f"{m['name']}")
            values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(res.questions),
        "failed": 0,
        "metrics": values,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, (v, lim) in compared.items()}
    warm_s = t_start + setup_s - t_warm
    notes.append(f"window {res.seconds:.3f} s, {res.calls} calls, "
                 f"{res.questions} questions, setup {setup_s:.2f} s "
                 f"(generation {t_build - t_gen:.1f} s, the program's build "
                 f"{t_warm - t_build:.1f} s, warm-up {warm_s:.1f} s)")
    per = res.questions / max(res.calls, 1)
    quarters = [sum(1 for t in res.at if q * res.seconds / 4 < t
                    <= (q + 1) * res.seconds / 4) * per / (res.seconds / 4)
                for q in range(4)]
    notes.append("q/s by quarter of the window: "
                 + ", ".join(f"{v:.0f}" for v in quarters))
    return result, compared, notes, control_numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    cell = spec.find_cell(args.workload)
    chips = {w["name"]: int(w["chips"]) for w in spec.load_json(
        ROOT / "BENCHMARK.json")["workloads"]}[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}. No CPU fallback.")
        return 3
    import a_modular_rag_framework_torch  # noqa: F401  (the program)

    log(f"card: {card_line()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    result, compared, notes, _ = run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START)
    for n in notes:
        log(n)
    found = forbidden_modules()
    if found:
        log(f"run: JAX or the JAX package loaded in this process: {found}")
        return 4
    print(json.dumps(result), flush=True)
    for name, (v, lim) in compared.items():
        log(f"compared {name}: {v!r} limit {lim!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
