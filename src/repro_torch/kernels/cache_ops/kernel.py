"""The cache hot path's CUDA kernels: their wrappers and their plain
PyTorch versions.

**Victim threshold** — replaces
``repro/kernels/cache_ops/kernel.py::victim_threshold_pallas``.  Both
versions take the int32 eviction keys, work in the order-preserving uint32
domain (``u = key ^ 0x80000000``), and return ``(t, n_gt)``: ``t`` the
kv-th largest ``u`` (an int64 0-dim tensor holding the uint32 value) and
``n_gt`` the count of keys strictly above it (int32 0-dim).  Both stay on
the tensor's device; nothing syncs the host.

* :func:`victim_threshold_plain` — int64 keys offset by 2**31 and the same
  33 rounds (32 bit rounds of "count keys >= candidate", then one count of
  keys > t) as torch ops.
* :func:`victim_threshold` — on a CUDA tensor it launches the hand-written
  kernel in ``csrc/victim_threshold.cu`` (one launch: a radix select of 4
  8-bit digit passes over the keys held in shared memory, the CTAs'
  histograms merged across a cooperative grid; see the note there) or
  raises; on a CPU tensor it takes the plain version.
  ``victim_threshold.launches`` counts kernel launches.

**Tiered-arena gather + decode** — replaces
``repro/kernels/cache_ops/kernel.py::gather_decode_pallas``.  Given the fp32
head ``[H, D]``, the fp16 / int8 tail ``[T, D]`` (int8 with its ``[T, 2]``
``(scale, zp)`` sideband) and int32 slots ``[K]``, both versions return the
fp32 ``[K, D]`` rows: head rows as stored, tail rows decoded, zero rows for
slots outside ``[0, H + T)``.

* :func:`gather_decode_plain` — ``ref.arena_gather`` with the store codec's
  eager decode (``q * scale + zp`` as two torch ops).
* :func:`gather_decode` — on CUDA tensors it launches the hand-written
  kernel in ``csrc/gather_decode.cu`` (bound by bytes: one read of each
  lane's row, one write of its output row) or raises; on CPU tensors it
  takes the plain version.  The kernel decodes without a fused
  multiply-add, so it is bitwise the plain version.
* :func:`gather_decode_encode_plain` / :func:`gather_decode_encode` — the
  same rows as a host tier of codec ``host_codec`` (fp16 or int8) stores
  them, ``(payload, sideband or None)``: the plain version is
  :func:`gather_decode_plain` followed by the codec's eager ``encode``; the
  kernel (the second entry of ``csrc/gather_decode.cu``) encodes each row
  in registers, one launch in place of ~14 torch ops, and writes no fp32
  rows.  Bitwise the plain version on finite rows (see the source's note
  on a row whose extremes are zeros of both signs).

``gather_decode.launches`` counts launches of both entries and
``gather_decode.fused_launches`` those of the fused one.

**Bucketize** — replaces ``repro/kernels/cache_ops/kernel.py::bucketize_pallas``.
Given int32 ``owner[U]`` and ``local[U]`` (-1 on padding and replicated
lanes) and the shard count ``S``, both versions return the int32 ``[S, U]``
routing image: ``out[s, i] = local[i]`` where ``owner[i] == s`` and
``local[i] >= 0``, else -1.

* :func:`bucketize_plain` — the where-image as three torch ops.
* :func:`bucketize` — on CUDA tensors it launches the hand-written kernel
  in ``csrc/bucketize.cu`` (one pass over the lanes for all S rows, 16 B
  loads and stores; bound by bytes) or raises; on CPU tensors it takes the
  plain version.
* :func:`route_bucketize_plain` / :func:`route_bucketize` — the sharded
  router's route and image in one call: the dedup'd ranks ``uniq[U]``
  through the slab's ``rank_owner`` / ``rank_local`` tables (-1 for a
  rank below ``rep_k``, the replicated head, or outside the tables), then
  the image; returns ``(owner, local, image)``.  The plain version is
  :func:`route_plain` (the collection's ``_route``) then
  :func:`bucketize_plain`; the kernel routes in the same launch as the
  image (the route prologue of ``csrc/bucketize.cu``), one launch in place
  of ~17.
* :func:`route_image_plain` / :func:`route_image` — the image alone, what
  the sharded plan uses: the same kernel with owner and local left
  unwritten.

``bucketize.launches`` counts launches of both entries and
``bucketize.fused_launches`` those of the fused one (both route calls).

Every wrapper launches through :class:`build.Kernel`: its C entry bound
once, its checks a few attribute reads, nothing allocated but its outputs.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.lanes import take_fill
from repro_torch.kernels import build

__all__ = [
    "BUCKETIZE_SOURCE",
    "GATHER_DECODE_SOURCE",
    "SOURCE",
    "bucketize",
    "bucketize_plain",
    "gather_decode",
    "gather_decode_encode",
    "gather_decode_encode_plain",
    "gather_decode_plain",
    "route_bucketize",
    "route_bucketize_plain",
    "route_image",
    "route_image_plain",
    "route_plain",
    "victim_threshold",
    "victim_threshold_plain",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "victim_threshold.cu"
GATHER_DECODE_SOURCE = SOURCE.with_name("gather_decode.cu")
BUCKETIZE_SOURCE = SOURCE.with_name("bucketize.cu")
_SIGN = 2**31


def victim_threshold_plain(key: torch.Tensor, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, n_gt) by 33 masked counts over int64 keys offset by 2**31."""
    kv = int(kv)
    u = key.to(torch.int64) + _SIGN
    t = torch.zeros((), dtype=torch.int64, device=key.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        cnt = (u >= cand).sum()
        t = torch.where(cnt >= kv, cand, t)
    return t, (u > t).sum().to(torch.int32)


_THRESHOLD_SCRATCH = 2 + 512  # int64 words: t, n_gt, then 4 x 256 uint32 histograms
_threshold_entry = None


def victim_threshold(key: torch.Tensor, kv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, n_gt) of the int32 keys: the CUDA kernel on a CUDA tensor (one
    launch), the plain version on a CPU tensor."""
    global _threshold_entry
    kv = int(kv)
    if key.device.type == "cpu":
        return victim_threshold_plain(key, kv)
    if not key.is_cuda:
        raise ValueError(f"victim_threshold: unsupported device {key.device}")
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError(
            f"victim_threshold takes contiguous int32 [n] keys, got {key.dtype} {tuple(key.shape)}"
        )
    n = key.shape[0]
    if not 1 <= kv <= n:
        raise ValueError(f"victim_threshold: kv={kv} outside [1, {n}]")
    if _threshold_entry is None:
        _threshold_entry = build.entry(SOURCE, "victim_threshold", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p])
    # one allocation: t, n_gt and the kernel's scratch are views of it
    buf = torch.empty((_THRESHOLD_SCRATCH,), dtype=torch.int64, device=key.device)
    ptr = buf.data_ptr()
    args = (key.data_ptr(), n, kv, ptr, ptr + 8, ptr + 16)
    if key.device.index == torch.cuda.current_device():
        err = _threshold_entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(key.device):
            err = _threshold_entry(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"victim_threshold kernel launch failed: CUDA error {err}")
    victim_threshold.launches += 1
    return buf[0], buf[1:2].view(torch.int32)[0]


victim_threshold.launches = 0


# codec -> (the kernel's code, payload dtype, sideband dtype or None)
_GD_CODECS = {"fp16": (0, torch.float16, None), "int8": (1, torch.int8, torch.float32)}
# the C entries and the fields of their argument structs
_gather_decode = build.Kernel(GATHER_DECODE_SOURCE, "gather_decode", 10)
_gather_decode_encode = build.Kernel(GATHER_DECODE_SOURCE, "gather_decode_encode", 12)
_bucketize = build.Kernel(BUCKETIZE_SOURCE, "bucketize", 5)
_route_bucketize = build.Kernel(BUCKETIZE_SOURCE, "route_bucketize", 10)


def _cpu_or_raise(name: str, tensors) -> None:
    """Returns when every tensor lies on the CPU (the plain route), raises
    when they are on mixed or unsupported devices."""
    if not all(t.device.type == "cpu" for t in tensors):
        raise ValueError(f"{name}: tensors on mixed or unsupported devices "
                         f"{sorted({str(t.device) for t in tensors})}")


def _gd_card(head, tail, sideband, slots, codec, name) -> int:
    """The card of a gather-decode call's tensors, after the checks its
    kernel needs (device, dtype, shape, contiguity; the C entry checks the
    sizes); -1 when they all lie on the CPU."""
    spec = _GD_CODECS.get(codec)
    if spec is None:
        raise ValueError(f"{name} supports fp16/int8 tails, got {codec!r}")
    i = head.get_device()
    if i < 0:
        _cpu_or_raise(name, [head, tail, slots] + ([] if sideband is None else [sideband]))
        return -1
    if (tail.get_device(), slots.get_device(),
            i if sideband is None else sideband.get_device()) != (i, i, i):
        raise ValueError(f"{name}: tensors on mixed devices")
    if (head.dtype, tail.dtype, slots.dtype,
            None if sideband is None else sideband.dtype) != (torch.float32, spec[1],
                                                              torch.int32, spec[2]):
        raise ValueError(f"{name}: want an fp32 head, a {codec} tail "
                         f"{'with' if spec[2] else 'and no'} fp32 sideband and int32 slots, got "
                         f"{head.dtype}, {tail.dtype}, {slots.dtype}, "
                         f"{None if sideband is None else sideband.dtype}")
    hs, ts = head.shape, tail.shape
    if (len(hs) != 2 or len(ts) != 2 or ts[1] != hs[1] or slots.dim() != 1
            or (sideband is not None and sideband.shape != (ts[0], 2))):
        raise ValueError(f"{name}: want head [H, D], tail [T, D], sideband [T, 2] and slots "
                         f"[K], got {tuple(hs)}, {tuple(ts)}, "
                         f"{None if sideband is None else tuple(sideband.shape)}, "
                         f"{tuple(slots.shape)}")
    if not (head.is_contiguous() and tail.is_contiguous() and slots.is_contiguous()
            and (sideband is None or sideband.is_contiguous())):
        raise ValueError(f"{name}: every tensor must be contiguous")
    return i


def gather_decode_plain(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
) -> torch.Tensor:
    """fp32 ``[K, D]`` rows of ``slots``: masked takes of head, tail and
    sideband, the codec's eager decode, then a per-lane select."""
    from repro_torch.kernels.cache_ops.ref import arena_gather  # ref imports this module
    from repro_torch.store.codec import get_codec

    return arena_gather(head, tail, sideband, slots, get_codec(codec).decode, torch.float32)


def gather_decode(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
) -> torch.Tensor:
    """fp32 ``[K, D]`` rows of ``slots``: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    i = _gd_card(head, tail, sideband, slots, codec, "gather_decode")
    if i < 0:
        return gather_decode_plain(head, tail, sideband, slots, codec)
    h, d = head.shape
    k = slots.shape[0]
    out = torch.empty((k, d), dtype=torch.float32, device=head.device)
    if k:
        _gather_decode(i, head.data_ptr(), h, tail.data_ptr(), tail.shape[0],
                       0 if sideband is None else sideband.data_ptr(), slots.data_ptr(), k, d,
                       _GD_CODECS[codec][0], out.data_ptr())
        gather_decode.launches += 1
    return out


gather_decode.launches = 0
gather_decode.fused_launches = 0


def gather_decode_encode_plain(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
    host_codec: str,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rows of ``slots`` encoded by ``host_codec``: the plain gather +
    decode, then the codec's eager encode."""
    from repro_torch.store.codec import get_codec

    return get_codec(host_codec).encode(gather_decode_plain(head, tail, sideband, slots, codec))


def gather_decode_encode(
    head: torch.Tensor,
    tail: torch.Tensor,
    sideband: Optional[torch.Tensor],
    slots: torch.Tensor,
    codec: str,
    host_codec: str,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rows of ``slots`` as a host tier of ``host_codec`` (fp16 / int8)
    stores them, ``(payload [K, D], sideband [K, 2] or None)``: the CUDA
    kernel (one launch) on CUDA tensors, the plain version on CPU tensors."""
    host = _GD_CODECS.get(host_codec)
    if host is None:
        raise ValueError(f"gather_decode_encode encodes for fp16/int8 hosts, got {host_codec!r}")
    i = _gd_card(head, tail, sideband, slots, codec, "gather_decode_encode")
    if i < 0:
        return gather_decode_encode_plain(head, tail, sideband, slots, codec, host_codec)
    h, d = head.shape
    k = slots.shape[0]
    dev = head.device
    payload = torch.empty((k, d), dtype=host[1], device=dev)
    side = None if host[2] is None else torch.empty((k, 2), dtype=torch.float32, device=dev)
    if k:
        _gather_decode_encode(i, head.data_ptr(), h, tail.data_ptr(), tail.shape[0],
                              0 if sideband is None else sideband.data_ptr(), slots.data_ptr(),
                              k, d, _GD_CODECS[codec][0], payload.data_ptr(), host[0],
                              0 if side is None else side.data_ptr())
        gather_decode.launches += 1
        gather_decode.fused_launches += 1
    return payload, side


def bucketize_plain(owner: torch.Tensor, local: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 ``[S, U]`` routing image by a shard-id column, a mask and a
    select."""
    sids = torch.arange(int(num_shards), dtype=torch.int32, device=owner.device)[:, None]
    mine = (owner[None, :] == sids) & (local[None, :] >= 0)
    return torch.where(mine, local[None, :], -1).to(torch.int32)


def _shards(num_shards) -> int:
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"bucketize: num_shards must be >= 1, got {num_shards}")
    return num_shards


def bucketize(owner: torch.Tensor, local: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 ``[S, U]`` routing image: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    i = owner.get_device()
    if i < 0:
        _cpu_or_raise("bucketize", (owner, local))
        return bucketize_plain(owner, local, num_shards)
    if local.get_device() != i:
        raise ValueError(f"bucketize: tensors on mixed devices {owner.device}, {local.device}")
    num_shards = _shards(num_shards)
    u = owner.shape
    if ((owner.dtype, local.dtype) != (torch.int32, torch.int32) or len(u) != 1
            or local.shape != u or not (owner.is_contiguous() and local.is_contiguous())):
        raise ValueError(f"bucketize: owner and local must be contiguous int32 [U], got "
                         f"{owner.dtype} {tuple(u)}, {local.dtype} {tuple(local.shape)}")
    po, pl = owner.data_ptr(), local.data_ptr()
    if (po | pl) % 16:
        raise ValueError("bucketize: owner and local must start on a 16 B boundary")
    u = u[0]
    out = torch.empty((num_shards, u), dtype=torch.int32, device=owner.device)
    if u:
        _bucketize(i, po, pl, u, num_shards, out.data_ptr())
        bucketize.launches += 1
    return out


bucketize.launches = 0
bucketize.fused_launches = 0


def route_plain(rank: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor,
                rep_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranks -> (owning shard, local row), -1 on a rank below ``rep_k`` (the
    replicated head, and padding below 0) or outside the tables (the
    padding rank)."""
    ok = rank >= rep_k
    safe = torch.where(ok, rank, 0)
    return (torch.where(ok, take_fill(rank_owner, safe, -1), -1),
            torch.where(ok, take_fill(rank_local, safe, -1), -1))


def route_bucketize_plain(uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor,
                          rep_k: int, num_shards: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(owner, local, image)`` of the dedup'd ranks ``uniq``: the route's
    torch ops, then :func:`bucketize_plain`."""
    owner, local = route_plain(uniq, rank_owner, rank_local, rep_k)
    return owner, local, bucketize_plain(owner, local, num_shards)


def _route_card(uniq, rank_owner, rank_local, num_shards, name) -> int:
    """The card of a route call's tensors, after the checks its kernel
    needs; -1 when they all lie on the CPU."""
    i = uniq.get_device()
    if i < 0:
        _cpu_or_raise(name, (uniq, rank_owner, rank_local))
        return -1
    if (rank_owner.get_device(), rank_local.get_device()) != (i, i):
        raise ValueError(f"{name}: tensors on mixed devices")
    _shards(num_shards)
    n = rank_owner.shape
    if ((uniq.dtype, rank_owner.dtype, rank_local.dtype) != (torch.int32,) * 3
            or uniq.dim() != 1 or len(n) != 1 or rank_local.shape != n
            or not (uniq.is_contiguous() and rank_owner.is_contiguous()
                    and rank_local.is_contiguous())):
        raise ValueError(f"{name}: want contiguous int32 uniq [U] and tables [N], got "
                         f"{uniq.dtype} {tuple(uniq.shape)}, {rank_owner.dtype} {tuple(n)}, "
                         f"{rank_local.dtype} {tuple(rank_local.shape)}")
    return i


def route_bucketize(uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor,
                    rep_k: int, num_shards: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(owner [U], local [U], image [S, U])``, int32, of the dedup'd ranks
    ``uniq``: the CUDA kernel (one launch) on CUDA tensors, the plain
    version on CPU tensors."""
    i = _route_card(uniq, rank_owner, rank_local, num_shards, "route_bucketize")
    if i < 0:
        return route_bucketize_plain(uniq, rank_owner, rank_local, rep_k, num_shards)
    num_shards = int(num_shards)
    u = uniq.shape[0]
    out = torch.empty((num_shards + 2, u), dtype=torch.int32, device=uniq.device)
    if u:
        p = out.data_ptr()
        _route_bucketize(i, uniq.data_ptr(), u, rank_owner.data_ptr(), rank_local.data_ptr(),
                         rank_owner.shape[0], int(rep_k), num_shards, p,
                         p + 4 * num_shards * u, p + 4 * (num_shards + 1) * u)
        bucketize.launches += 1
        bucketize.fused_launches += 1
    return out[num_shards], out[num_shards + 1], out[:num_shards]


def route_image_plain(uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor,
                      rep_k: int, num_shards: int) -> torch.Tensor:
    """The ``[S, U]`` image of :func:`route_bucketize_plain`."""
    return route_bucketize_plain(uniq, rank_owner, rank_local, rep_k, num_shards)[2]


def route_image(uniq: torch.Tensor, rank_owner: torch.Tensor, rank_local: torch.Tensor,
                rep_k: int, num_shards: int) -> torch.Tensor:
    """The int32 ``[S, U]`` image of the dedup'd ranks ``uniq``, what the
    sharded plan needs: the CUDA kernel of :func:`route_bucketize` (one
    launch) writing the image alone on CUDA tensors, the plain version on
    CPU tensors."""
    i = _route_card(uniq, rank_owner, rank_local, num_shards, "route_image")
    if i < 0:
        return route_image_plain(uniq, rank_owner, rank_local, rep_k, num_shards)
    num_shards = int(num_shards)
    u = uniq.shape[0]
    out = torch.empty((num_shards, u), dtype=torch.int32, device=uniq.device)
    if u:
        _route_bucketize(i, uniq.data_ptr(), u, rank_owner.data_ptr(), rank_local.data_ptr(),
                         rank_owner.shape[0], int(rep_k), num_shards, out.data_ptr(), 0, 0)
        bucketize.launches += 1
        bucketize.fused_launches += 1
    return out
