"""The ten building blocks of the fused window attention (csrc/constructs.cu).

hotformerloc_tpu/tools/mosaic_probe.py:constructs compiled each of these
as its own Pallas kernel through ``_run`` (T3), to learn which constructs
the TPU's compiler accepts. Each wrapper here launches one CUDA kernel
that computes the construct's function with its roundings, on CUDA
tensors, and runs the ``*_reference`` plain version beside it on CPU
tensors. ``CONSTRUCTS`` maps each name to (wrapper, plain version, line
of the TPU kernel body in mosaic_probe.py); ``BODIES`` names the kernel
body each construct runs on the card: the three products share one
tensor-core body ("tc"), dtab runs as one thread-block cluster
("cluster"), softmax holds a row in a warp's registers ("rows",
``softmax_plan``), onehot4d and pad write flat runs of 16-byte streaming
stores ("vec", ``onehot_plan``, ``pad_plan``), the other three are one
thread per output ("simt").

``floor_empty`` and ``floor_chain`` launch the two kernels that measure
the card's floor for the constructs (an empty launch; a dependent index
and row load and a store); they replace no TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from hotformerloc_torch.ops import kernels
from hotformerloc_torch.ops.kernels import build
from hotformerloc_torch.ops.kernels.gather import (BLOCK_WARPS, SMS,
                                                   take_plan)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _launch(name, argtypes, t0, *args):
    """Launch construct ``name`` on t0's device and count it."""
    fn = build.bind("constructs", f"construct_{name}", argtypes + [_P])
    build.check(fn(*args, build.stream_ptr(t0.device)), f"construct_{name}")
    kernels.LAUNCHES[f"construct_{name}"] += 1


def _on_card(name, *ts, dtypes):
    """True for CUDA inputs of the expected dtypes, contiguous, on one
    device; False for CPU inputs; raises otherwise."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"construct_{name}: unsupported device {dev}")
    for t, dt in zip(ts, dtypes):
        if t.device != dev or not t.is_contiguous() or t.dtype != dt:
            raise ValueError(f"construct_{name}: want contiguous {dt} on "
                             f"{dev}, got {t.dtype} on {t.device}")
    return True


_BF, _F32, _I32 = torch.bfloat16, torch.float32, torch.int32
DTAB_CLUSTER = 16             # dtab: blocks of its cluster (a non-portable
DTAB_THREADS = 1024           # size) and threads per block


def _check_product(name, q, k, hd, width):
    """The tensor-core body's shapes: q, k (WT, T, C) alike, 16-byte
    aligned rows, hd a multiple of 16 and ``width`` lanes within C."""
    if q.dim() != 3 or k.shape != q.shape or q.shape[2] % 8 \
            or hd % 16 or width > q.shape[2] \
            or q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError(f"construct_{name}: want q, k (WT, T, C) alike, "
                         f"16-byte aligned, C % 8 == 0, hd % 16 == 0 and "
                         f"{width} lanes <= C; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, hd={hd}")


# -- k_headloop: two 16-lane head slices, fp32 per-head products ------------

def headloop_reference(q, k, hd=16):
    acc = torch.zeros(q.shape[0], q.shape[1], k.shape[1],
                      dtype=torch.float32, device=q.device)
    for h in range(2):
        sl = slice(h * hd, (h + 1) * hd)
        acc += torch.einsum("wtd,wsd->wts", q[..., sl].float(),
                            k[..., sl].float())
    return acc


def headloop(q, k, hd=16):
    """out[w,t,s] = sum_{h<2} q_h[w,t] . k_h[w,s] over lanes h*hd..; q, k
    (WT, T, C) bf16 -> (WT, T, T) fp32."""
    if not _on_card("headloop", q, k, dtypes=(_BF, _BF)):
        return headloop_reference(q, k, hd)
    _check_product("headloop", q, k, hd, 2 * hd)
    WT, T, C = q.shape
    out = torch.empty((WT, T, T), dtype=_F32, device=q.device)
    _launch("headloop", [_P] * 3 + [_I] * 4, q, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), WT, T, C, hd)
    return out


# -- k_reshape: int32 (WT, K, K) -> float32 (WT*K*K, 1) ---------------------

def reshape_reference(idx):
    return idx.reshape(-1, 1).float()


def reshape(idx):
    if not _on_card("reshape", idx, dtypes=(_I32,)):
        return reshape_reference(idx)
    out = torch.empty((idx.numel(), 1), dtype=_F32, device=idx.device)
    _launch("reshape", [_P, _P, _L], idx, idx.data_ptr(), out.data_ptr(),
            idx.numel())
    return out


# -- k_onehot4d: one-hot (.., R) bf16 times tab (R, H) bf16 -----------------

def onehot4d_reference(idx, tab):
    R = tab.shape[0]
    t = tab.to(_BF).float()
    ok = (idx >= 0) & (idx < R)
    g = t[idx.clamp(0, R - 1).long()]
    return torch.where(ok[..., None], g, torch.zeros_like(g))


def onehot_plan(rows: int, H: int) -> dict:
    """onehot4d's launch plan for ``rows`` output rows of H floats:
    {"vec": floats a unit (4, a 16-byte vector, when H % 4 == 0, else
    1), and ``gather.take_plan``'s "per_lane", "threads", "blocks" for
    rows of H / vec units}: a warp writes 32 * per_lane consecutive units
    of the flat output and touches at most 32 rows, whose indices its
    lanes read in one load."""
    if rows < 1 or H < 1 or rows * H >= 2 ** 31:
        raise ValueError(f"construct_onehot4d: no plan for {rows} rows of "
                         f"{H}")
    vec = 4 if H % 4 == 0 else 1
    return {"vec": vec, **take_plan(rows, H // vec)}


def onehot4d(idx, tab):
    """out[..., h] = float(bf16(tab[idx[...], h])), 0 where idx is off
    the table; idx int32, tab (R, H) fp32; launched as ``onehot_plan``
    says."""
    if not _on_card("onehot4d", idx, tab, dtypes=(_I32, _F32)):
        return onehot4d_reference(idx, tab)
    R, H = tab.shape
    if R * H >= 2 ** 31 or tab.data_ptr() % 16:
        raise ValueError("construct_onehot4d: want tab 16-byte aligned, "
                         "below 2^31 entries")
    plan = onehot_plan(idx.numel(), H)
    out = torch.empty((*idx.shape, H), dtype=_F32, device=idx.device)
    _launch("onehot4d", [_P] * 3 + [_L, _I, _I, _I, _I, _I, _L], idx,
            idx.data_ptr(), tab.data_ptr(), out.data_ptr(), idx.numel(), H,
            R, plan["vec"], plan["per_lane"], plan["threads"],
            plan["blocks"])
    return out


# -- k_dtab: the adjoint, one-hot^T g contracted over the three majors ------

def dtab_reference(idx, g, R):
    H = g.shape[-1]
    ok = ((idx >= 0) & (idx < R)).reshape(-1)
    out = torch.zeros((R, H), dtype=_F32, device=g.device)
    out.index_add_(0, idx.reshape(-1)[ok].long(),
                   g.to(_BF).float().reshape(-1, H)[ok])
    return out


def dtab_plan(n, H, R, smem=build.SMEM_OPTIN) -> dict:
    """dtab's launch on the card: one cluster of ``DTAB_CLUSTER`` blocks
    of ``DTAB_THREADS``, each staging ``rows_per_block`` of the n (idx,
    g) rows (a multiple of 4, so each share starts 16-byte aligned),
    sorting them by bin and summing them into R * H fp32 bins (padded to
    cluster slices of a multiple of 4 bins, which the blocks add in rank
    order);
    bins, sort tables and rows must fit ``smem`` bytes (the card's opt-in
    shared memory per block). Raises when they do not."""
    cs = DTAB_CLUSTER
    per = -(-n // cs) + 3 & ~3
    chunk = -(-R * H // cs) + 3 & ~3
    need = 4 * (cs * chunk + (2 * R + 1 + 3 & ~3) + per * (2 + H))
    if not (1 <= n and n * H < 2 ** 31 and 1 <= H <= DTAB_THREADS
            and R >= 1 and need <= smem):
        raise ValueError(f"construct_dtab: {R} x {H} fp32 bins and "
                         f"{per} rows a block ({need} bytes) do not fit "
                         f"{smem} bytes of shared memory, or H > "
                         f"{DTAB_THREADS}")
    return {"cluster": cs, "threads": DTAB_THREADS, "rows_per_block": per,
            "smem": need}


def dtab(idx, g, R):
    """out[r, h] = sum over idx[...] == r of float(bf16(g[..., h])), fp32;
    idx int32 (...), g fp32 (..., H); launched as ``dtab_plan`` says."""
    if not _on_card("dtab", idx, g, dtypes=(_I32, _F32)):
        return dtab_reference(idx, g, R)
    H = g.shape[-1]
    if g.shape[:-1] != idx.shape or idx.data_ptr() % 16 \
            or g.data_ptr() % 16:
        raise ValueError("construct_dtab: want g (*idx.shape, H), both "
                         "16-byte aligned")
    plan = dtab_plan(idx.numel(), H, R, build.smem_optin(g.device))
    out = torch.empty((R, H), dtype=_F32, device=g.device)
    _launch("dtab", [_P] * 3 + [_L] + [_I] * 5, idx, idx.data_ptr(),
            g.data_ptr(), out.data_ptr(), idx.numel(), H, R,
            plan["cluster"], plan["threads"], plan["rows_per_block"])
    return out


# -- k_pad: (WT, K, K) -> (WT, K+G, K+G) with G leading zero rows/cols ------

def pad_reference(b, G=1):
    return F.pad(b, (G, 0, G, 0))


def pad_plan(WT: int, K: int, G: int) -> dict:
    """pad's launch plan for (WT, K, K) -> (WT, K+G, K+G): the output's
    ``total`` floats as ``vectors`` 16-byte vectors and a ``tail`` of
    fewer than 4, a thread each (one more thread for the tail), in
    blocks of ``gather.BLOCK_WARPS`` warps ("threads", "blocks")."""
    total = WT * (K + G) ** 2
    if WT < 1 or K < 1 or G < 0 or total >= 2 ** 31:
        raise ValueError(f"construct_pad: no plan for ({WT}, {K}, {K}) "
                         f"with {G} leading zeros")
    threads, writers = 32 * BLOCK_WARPS, -(-total // 4)
    return {"vectors": total // 4, "tail": total % 4, "threads": threads,
            "blocks": -(-writers // threads)}


def pad(b, G=1):
    """(WT, K, K) fp32 -> (WT, K+G, K+G) with G leading zero rows and
    columns; launched as ``pad_plan`` says."""
    if not _on_card("pad", b, dtypes=(_F32,)):
        return pad_reference(b, G)
    if b.dim() != 3 or b.shape[1] != b.shape[2]:
        raise ValueError("construct_pad: want (WT, K, K)")
    WT, K, _ = b.shape
    plan = pad_plan(WT, K, G)
    out = torch.empty((WT, K + G, K + G), dtype=_F32, device=b.device)
    _launch("pad", [_P, _P, _I, _I, _I, _I, _L], b, b.data_ptr(),
            out.data_ptr(), WT, K, G, plan["threads"], plan["blocks"])
    return out


# -- k_selloop: sum_{r < nsel} [idx == r] * tab[r, 0] -----------------------

def selloop_reference(idx, tab, nsel=4):
    acc = torch.zeros(idx.shape, dtype=_F32, device=idx.device)
    for r in range(nsel):
        acc += torch.where(idx == r, tab[r, 0], 0.0)
    return acc


def selloop(idx, tab, nsel=4):
    if not _on_card("selloop", idx, tab, dtypes=(_I32, _F32)):
        return selloop_reference(idx, tab, nsel)
    if tab.shape[0] < nsel:
        raise ValueError(f"construct_selloop: tab needs {nsel} rows")
    out = torch.empty(idx.shape, dtype=_F32, device=idx.device)
    _launch("selloop", [_P] * 3 + [_L, _I, _I], idx, idx.data_ptr(),
            tab.data_ptr(), out.data_ptr(), idx.numel(), nsel, tab.shape[1])
    return out


# -- k_softmax: fp32 softmax over the last axis -----------------------------

def softmax_reference(x):
    return torch.softmax(x, dim=-1)


SOFTMAX_MAX_L = 1024


def softmax_plan(rows: int, L: int) -> dict:
    """The softmax kernel's launch plan for ``rows`` rows of ``L``: a
    warp a row, {"per_lane": values a lane holds, the least power of two
    with 32 * per_lane >= L; "threads", "blocks": blocks of
    ``gather.BLOCK_WARPS`` warps}."""
    if not 1 <= L <= SOFTMAX_MAX_L or rows < 1:
        raise ValueError(f"construct_softmax: last axis of {L} (1 to "
                         f"{SOFTMAX_MAX_L}) over {rows} rows")
    per_lane = 1
    while 32 * per_lane < L:
        per_lane *= 2
    return {"per_lane": per_lane, "threads": 32 * BLOCK_WARPS,
            "blocks": -(-rows // BLOCK_WARPS)}


def softmax(x):
    if not _on_card("softmax", x, dtypes=(_F32,)):
        return softmax_reference(x)
    L = x.shape[-1]
    plan = softmax_plan(x.numel() // L, L)
    out = torch.empty_like(x)
    _launch("softmax", [_P, _P, _L, _I, _I, _I, _L], x, x.data_ptr(),
            out.data_ptr(), x.numel() // L, L, plan["per_lane"],
            plan["threads"], plan["blocks"])
    return out


# -- k_slicestore: out[..., :width] = 2 q[..., :width], bf16 ----------------

def slicestore_reference(q, width=32):
    return q[..., :width] * 2.0


def slicestore(q, width=32):
    if not _on_card("slicestore", q, dtypes=(_BF,)):
        return slicestore_reference(q, width)
    C = q.shape[-1]
    if width > C:
        raise ValueError("construct_slicestore: width above C")
    out = torch.empty((*q.shape[:-1], width), dtype=_BF, device=q.device)
    _launch("slicestore", [_P, _P, _L, _I, _I], q, q.data_ptr(),
            out.data_ptr(), q.numel() // C, C, width)
    return out


# -- k_dk: sum_t q[w,t,a] k[w,t,b] over the first hd lanes, fp32 ------------

def dk_reference(q, k, hd=16):
    return torch.einsum("wta,wtb->wab", q[..., :hd].float(),
                        k[..., :hd].float())


def dk(q, k, hd=16):
    if not _on_card("dk", q, k, dtypes=(_BF, _BF)):
        return dk_reference(q, k, hd)
    _check_product("dk", q, k, hd, hd)
    WT, T, C = q.shape
    out = torch.empty((WT, hd, hd), dtype=_F32, device=q.device)
    _launch("dk", [_P] * 3 + [_I] * 4, q, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), WT, T, C, hd)
    return out


# -- k_packbias: packed windows, q2 q2^T over the first hd lanes, fp32 ------

def packbias_reference(q, k, hd=16):
    return torch.einsum("wtd,wsd->wts", q[..., :hd].float(),
                        k[..., :hd].float())


def packbias(q, k, hd=16):
    if not _on_card("packbias", q, k, dtypes=(_BF, _BF)):
        return packbias_reference(q, k, hd)
    _check_product("packbias", q, k, hd, hd)
    WT, T, C = q.shape
    out = torch.empty((WT, T, T), dtype=_F32, device=q.device)
    _launch("packbias", [_P] * 3 + [_I] * 4, q, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), WT, T, C, hd)
    return out


CONSTRUCTS = {
    "headloop": (headloop, headloop_reference, 66),
    "reshape": (reshape, reshape_reference, 79),
    "onehot4d": (onehot4d, onehot4d_reference, 85),
    "dtab": (dtab, dtab_reference, 95),
    "pad": (pad, pad_reference, 107),
    "selloop": (selloop, selloop_reference, 113),
    "softmax": (softmax, softmax_reference, 122),
    "slicestore": (slicestore, slicestore_reference, 128),
    "dk": (dk, dk_reference, 136),
    "packbias": (packbias, packbias_reference, 146),
}
BODIES = {name: "simt" for name in CONSTRUCTS}
BODIES.update(headloop="tc", packbias="tc", dk="tc", dtab="cluster",
              softmax="rows", onehot4d="vec", pad="vec")


# -- the card's floor for the constructs (no TPU kernel) --------------------

def floor_empty(t):
    """Launch the empty kernel (one block of one warp) on t's card;
    returns t, so that a timer synchronises on it."""
    _check_floor(t)
    _launch("floor_empty", [], t)
    return t


def floor_chain_reference(x, idx):
    return x[idx.long()]


def floor_chain(x, idx, threads):
    """out[i] = x[idx[i]] for x (rows, 4) fp32 (one 16-byte vector a
    row), a thread an index: a dependent pair of loads (the index, then
    the row it names) and one store each, in blocks of ``threads`` (32:
    one warp; 128: 4-warp blocks) covering idx exactly."""
    _check_floor(x)
    n = idx.numel()
    if x.dim() != 2 or x.shape[1] != 4 or x.dtype != _F32 \
            or idx.dtype != _I32 or not (x.is_contiguous()
                                         and idx.is_contiguous()) \
            or idx.device != x.device or threads not in (32, 128) \
            or n % threads or not n or x.data_ptr() % 16:
        raise ValueError(f"construct_floor_chain: want x (rows, 4) fp32 "
                         f"and int32 idx of a multiple of {threads} on "
                         f"one card")
    out = torch.empty((n, 4), dtype=_F32, device=x.device)
    _launch("floor_chain", [_P, _P, _P, _I, _I], x, idx.data_ptr(),
            x.data_ptr(), out.data_ptr(), threads, n // threads)
    return out


def _check_floor(t):
    if t.device.type != "cuda":
        raise ValueError(f"construct_floor: the floor is measured on the "
                         f"card, not on {t.device}")


FLOOR_GRID = (32 * BLOCK_WARPS, SMS)   # threads, blocks: a block an SM
