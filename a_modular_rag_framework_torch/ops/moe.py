"""A mixture-of-experts layer: softmax routing over every expert, the
routed tokens permuted by expert, grouped expert products, a weighted
combine back to tokens, and shared experts on every position.

    out = moe_layer(x, router_w, experts, shared, top_k, experts_held)

- `route`: the router in float32 (softmax over all experts, greedy
  top-k, the weights not renormalized: DeepSeek-V2's ``topk_method``
  ``greedy``, ``norm_topk_prob`` false).
- `moe_gemm`: the routed products for the tokens permuted by expert,
  SiLU(x Wg^T) * (x Wu^T) then . Wd^T, each row scaled by its routing
  weight and written to its slot. CUDA tensors take the hand-written
  kernel (``csrc/moe_gemm.cu``, `moe_gemm_cuda`); CPU tensors the plain
  version, `moe_reference` (a product per expert in torch). There is no
  fallback.
- `moe_layer`: the whole layer. It routes over all experts and computes
  the part of the result its held experts give (``experts_held``): with
  experts spread over several cards, each card's layer gives its own
  experts' part, and the parts add up to the whole layer (the shared
  experts counted once). There is no exchange here.

Precision: products on bfloat16 operands with float32 sums; the router,
the softmax, the SiLU gate and the combine in float32; the expert's hidden
activation is rounded to bfloat16 as the down product's operand.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..telemetry.stages import count_moe, stage
from ._build import load_library

# csrc/moe_gemm.cu: rows of a tile, the widths it takes
TILE_ROWS = 128
_H_STEP = 256
_F_STEP = 128


def matmul_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` with both operands rounded to bfloat16 and float32
    sums and result; ``w`` is [out, in]. On a CUDA device the rounded
    operands go to the tensor cores (``torch.mm(..., out_dtype=float32)``);
    on the CPU they are widened back and multiplied in float32. A product
    of two bfloat16 values is exact in float32, so the two differ in
    summation order only."""
    a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    if a2.device.type == "cuda":
        out = torch.mm(a2, wb.t(), out_dtype=torch.float32)
    else:
        out = a2.float() @ wb.float().t()
    return out.reshape(*a.shape[:-1], w.shape[0])


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor],
           rows: int = 32768) -> torch.Tensor:
    """SiLU(x Wg^T) * (x Wu^T), rounded to bfloat16, then . Wd^T (weights
    [out, in]); float32 out. ``rows`` rows at a time, so the float32
    gate and up activations of a wide MLP stay a few GB."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty((flat.shape[0], p["w_down"].shape[0]),
                      dtype=torch.float32, device=x.device)
    for i in range(0, flat.shape[0], rows):
        xs = flat[i:i + rows]
        h = F.silu(matmul_t(xs, p["w_gate"]), inplace=True)
        h.mul_(matmul_t(xs, p["w_up"]))
        out[i:i + rows] = matmul_t(h.to(torch.bfloat16), p["w_down"])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32 [T, top_k], experts int64 [T, top_k]) of tokens ``x``
    [T, H]: softmax over every expert of the float32 product with
    ``router_w`` [E, H], the ``top_k`` largest (greedy), times
    ``scaling``."""
    scores = torch.softmax(x.float() @ router_w.float().t(), dim=-1)
    w, e = torch.topk(scores, top_k, dim=-1)
    return w * scaling, e


def tile_table(counts: torch.Tensor, offsets: torch.Tensor, rows: int
               ) -> Tuple[torch.Tensor, ...]:
    """The kernel's row tiles, on the counts' device without a wait:
    (expert, first row, rows) int32 of each tile of `TILE_ROWS` rows of
    one expert, in expert order, for at most ``rows`` routed rows, and
    their number (int32 [1])."""
    E = counts.numel()
    tiles = (counts + TILE_ROWS - 1) // TILE_ROWS
    cum = torch.cumsum(tiles, 0)
    bound = -(-rows // TILE_ROWS) + E
    m = torch.arange(bound, device=counts.device)
    e = torch.searchsorted(cum, m, right=True).clamp_(max=E - 1)
    local = m - (cum[e] - tiles[e])
    row0 = offsets[e] + local * TILE_ROWS
    n_rows = (counts[e] - local * TILE_ROWS).clamp(0, TILE_ROWS)
    return (e.to(torch.int32), row0.to(torch.int32), n_rows.to(torch.int32),
            cum[-1:].to(torch.int32))


def moe_reference(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, counts: torch.Tensor,
                  offsets: torch.Tensor, out_rows: torch.Tensor,
                  row_scale: torch.Tensor, n_out: int,
                  covered: bool = False) -> torch.Tensor:
    """The plain version of the grouped products: for each expert ``e``,
    its rows ``x[offsets[e] : offsets[e] + counts[e]]`` (x [rows, H],
    permuted by expert) through `swiglu` with ``w_gate[e]``, ``w_up[e]``
    [F, H] and ``w_down[e]`` [H, F], each row scaled by ``row_scale`` and
    written to row ``out_rows`` of the f32 result [n_out, H]; rows no
    expert writes stay zero (``covered``: the caller knows every row is
    written, which the kernel uses to skip zeroing)."""
    y = torch.zeros((n_out, w_down.shape[1]), dtype=torch.float32,
                    device=x.device)
    for e, (off, cnt) in enumerate(zip(offsets.tolist(), counts.tolist())):
        if cnt == 0:
            continue
        rows = slice(off, off + cnt)
        ye = swiglu(x[rows], {"w_gate": w_gate[e], "w_up": w_up[e],
                              "w_down": w_down[e]})
        y[out_rows[rows].long()] = ye * row_scale[rows, None].float()
    return y


def _library():
    lib, info = load_library("moe_gemm")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p,
                                        p, p, p, p, i, p]
        lib.moe_gemm_launch.restype = i
        lib.moe_gemm_error_string.argtypes = [i]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib, info


def build_moe_gemm() -> dict:
    """Build (or find built) the kernel's library; returns its build info."""
    return _library()[1]


def moe_gemm_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, counts: torch.Tensor,
                  offsets: torch.Tensor, out_rows: torch.Tensor,
                  row_scale: torch.Tensor, n_out: int,
                  covered: bool = False) -> torch.Tensor:
    """The hand-written kernel: `moe_reference`'s result, f32 [n_out, H].

    x: contiguous bf16 [rows, H] on a CUDA device; w_gate, w_up:
    contiguous bf16 [E, F, H], w_down [E, H, F]; counts, offsets: int64
    [E] on the device (rows of expert e: offsets[e] .. + counts[e], in
    expert order; an expert not held counts 0); out_rows: int [rows];
    row_scale: f32 [rows]. H a multiple of 256, F of 128.

    ``moe_gemm_cuda.launches`` counts the kernel's launches: two a call
    with routed rows (gate-up, then down), none without."""
    tensors = (x, w_gate, w_up, w_down, counts, offsets, out_rows, row_scale)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("moe_gemm_cuda takes CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("moe_gemm_cuda: tensors on several devices")
    if any(t.dtype != torch.bfloat16 for t in (x, w_gate, w_up, w_down)):
        raise TypeError("x and the expert weights must be bfloat16")
    E, Fw, H = w_gate.shape
    if (x.dim() != 2 or x.shape[1] != H or w_up.shape != w_gate.shape
            or w_down.shape != (E, H, Fw) or counts.shape != (E,)
            or offsets.shape != (E,) or out_rows.shape != x.shape[:1]
            or row_scale.shape != x.shape[:1]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_down "
                         f"{tuple(w_down.shape)}, counts "
                         f"{tuple(counts.shape)}")
    if H % _H_STEP or Fw % _F_STEP:
        raise ValueError(f"H={H} must be a multiple of {_H_STEP} and "
                         f"F={Fw} of {_F_STEP}")
    if not all(t.is_contiguous() for t in (x, w_gate, w_up, w_down)):
        raise ValueError("x and the expert weights must be contiguous")
    if x.shape[0] == 0:
        return torch.zeros((n_out, H), dtype=torch.float32, device=x.device)
    out = torch.ops.amrf.moe_gemm_launch(
        x, w_gate, w_up, w_down, counts.long(), offsets.long(),
        out_rows.to(torch.int32), row_scale.float().contiguous(), n_out,
        covered)
    moe_gemm_cuda.launches += 2
    return out


moe_gemm_cuda.launches = 0


def _launch(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, counts: torch.Tensor,
            offsets: torch.Tensor, out_rows: torch.Tensor,
            row_scale: torch.Tensor, n_out: int, covered: bool
            ) -> torch.Tensor:
    """The tile table and the kernel's two launches (gate-up, down) on the
    current stream, from the tensors `moe_gemm_cuda` checked."""
    lib, _ = _library()
    rows, H = x.shape
    E, Fw, _ = w_gate.shape
    dev = x.device
    t_expert, t_row0, t_rows, n_mtiles = tile_table(counts, offsets, rows)
    h = torch.empty((rows, Fw), dtype=torch.bfloat16, device=dev)
    y = (torch.empty if covered else torch.zeros)(
        (n_out, H), dtype=torch.float32, device=dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.moe_gemm_launch(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr(), y.data_ptr(), rows, E, H, Fw,
            t_expert.data_ptr(), t_row0.data_ptr(), t_rows.data_ptr(),
            n_mtiles.data_ptr(), out_rows.data_ptr(), row_scale.data_ptr(),
            blocks, stream)
    if err != 0:
        msg = lib.moe_gemm_error_string(err).decode()
        raise RuntimeError(f"moe_gemm kernel launch failed: {msg} ({err})")
    return y


# A torch operator, as ops/topk.py's launch is: a profiler ties the launch
# to its caller's thread and range through it.
_OPS = torch.library.Library("amrf", "FRAGMENT")
_OPS.define("moe_gemm_launch(Tensor x, Tensor w_gate, Tensor w_up, "
            "Tensor w_down, Tensor counts, Tensor offsets, Tensor out_rows, "
            "Tensor row_scale, int n_out, bool covered) -> Tensor")
_OPS.impl("moe_gemm_launch", _launch, "CUDA")


def moe_gemm(x, w_gate, w_up, w_down, counts, offsets, out_rows, row_scale,
             n_out: int, covered: bool = False) -> torch.Tensor:
    """CPU tensors -> `moe_reference`; CUDA tensors -> the kernel."""
    args = (x, w_gate, w_up, w_down, counts, offsets, out_rows, row_scale,
            n_out, covered)
    if x.device.type == "cuda":
        return moe_gemm_cuda(*args)
    if x.device.type == "cpu":
        return moe_reference(*args)
    raise ValueError(f"moe_gemm: unsupported device {x.device}")


def moe_layer(x: torch.Tensor, router_w: torch.Tensor,
              experts: Dict[str, torch.Tensor],
              shared: Optional[Dict[str, torch.Tensor]], top_k: int,
              experts_held: Optional[Sequence[int]] = None, *,
              real: Optional[torch.Tensor] = None, scaling: float = 1.0,
              counter: str = "model/moe",
              routes: Optional[list] = None) -> torch.Tensor:
    """The layer's output [T, H] f32 for tokens ``x`` [T, H] f32.

    ``router_w`` [E, H] routes over all E experts; ``experts`` holds the
    weights of the experts this layer holds (``w_gate``, ``w_up`` [E_held,
    F, H], ``w_down`` [E_held, H, F]), whose global ids are
    ``experts_held`` (all E, in order, when None). Only the positions
    ``real`` (an index, all when None) are routed; the others (padding)
    get the shared experts' output alone. ``shared`` (``w_gate``, ``w_up``
    [F_s, H], ``w_down`` [H, F_s]) runs on every position. Ranges:
    ``model/moe/route`` (router, top-k, permutation), ``model/moe/experts``
    (the grouped products and the combine), ``model/moe/shared``; while a
    profiler records, the routed slots go to `telemetry.stages.moe_table`
    under ``counter``. ``routes``, when a list, receives the experts
    chosen [routed tokens, top_k]."""
    E = router_w.shape[0]
    n_held = experts["w_gate"].shape[0]
    with stage("model/moe/route"):
        xr = x if real is None else x[real]
        T = xr.shape[0]
        weights, chosen = route(xr, router_w, top_k, scaling)
        if routes is not None:
            routes.append(chosen)
        flat = chosen.reshape(-1)
        if experts_held is None:
            local = flat
        else:
            held = torch.as_tensor(list(experts_held), dtype=torch.long,
                                   device=x.device)
            local_of = torch.full((E,), n_held, dtype=torch.long,
                                  device=x.device)
            local_of[held] = torch.arange(n_held, device=x.device)
            local = local_of[flat]  # n_held: an expert held elsewhere
        order = torch.argsort(local, stable=True)
        # a scatter, not bincount: bincount waits for the card (its size)
        counts = torch.zeros(n_held + 1, dtype=torch.long,
                             device=x.device).scatter_add_(
            0, local, torch.ones_like(local))[:n_held]
        offsets = torch.cumsum(counts, 0) - counts
        x_perm = xr.to(torch.bfloat16)[order // top_k]
        row_scale = weights.reshape(-1)[order]
    count_moe(counter, counts, experts["w_gate"].shape)
    with stage("model/moe/experts"):
        y = moe_gemm(x_perm, experts["w_gate"], experts["w_up"],
                     experts["w_down"], counts, offsets, order, row_scale,
                     T * top_k, covered=n_held == E)
        routed = y.view(T, top_k, -1).sum(dim=1)
    with stage("model/moe/shared"):
        out = (swiglu(x, shared) if shared is not None
               else torch.zeros_like(x, dtype=torch.float32))
    if real is None:
        return out + routed
    return out.index_add_(0, real, routed)
