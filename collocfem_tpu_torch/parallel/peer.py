"""The multi-rank tier's all-reduce: the peer-memory kernel's wrapper, its
set-up and its plain version.

Every collective of ``parallel.meshes`` (a sum, a max, a gather in rank
order, the halos) is one call of :func:`peer_reduce` on a float64 vector.
On a CUDA tensor it launches ``csrc/peer_reduce.cu``: each rank writes its
payload into its slot of every peer's buffer (mapped by CUDA IPC), posts a
flag, waits for every peer's flag and reduces the P slots in rank order.
That is a plain kernel node, which a CUDA-graph WHILE body takes (NCCL's
kernels of several ranks it refuses), and it runs between processes that
share one card (NCCL refuses two ranks on one card) as between the cards
of one host.  On a CPU tensor :func:`peer_reduce_ref` runs: the exact
gather (an ``all_reduce`` of a zero-filled buffer in which each rank fills
its own slot, which adds only zeros) and then the same rank-ordered
accumulation, ``acc = slot 0; acc = acc + slot 1; ...``, so the kernel and
the plain version agree bit for bit and every rank gets the same bits.

The group is set up once, eagerly (:func:`setup`: when a CUDA mesh or a
sharded solver is made, else at the group's first collective, which must
not be inside a capture): each rank allocates a buffer of two parities of
P slots of :data:`CAPACITY` doubles and P flags, and the ranks exchange
its IPC handle through the group itself.  A payload longer than a slot
goes in chunks, one launch each.  The call's epoch is a counter on the
device that the kernel advances, so a captured call replays with no value
from the host; every rank must issue the same calls on a group in the same
order (captured, replayed or eager alike).

Every wait is bounded (:data:`SPIN_TIMEOUT_S`): a rank that times out sets
its group's error word and writes NaN, now and in every later call on the
group, so nothing hangs; :func:`check` reads the words of a solver's
groups after a solve (one synchronisation of the stream) and raises.
Nothing falls back: a group whose ranks cannot map each other's buffers is
refused (:func:`setup` returns why) and its collectives on a CUDA tensor
raise.  :func:`release` frees a group's buffers and mappings once its
ranks are done with it, before the group is destroyed.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from collocfem_tpu_torch.ops import _build

SUM, MAX, GATHER = 0, 1, 2
CAPACITY = 1 << 15          # doubles a slot holds (256 KiB); more in chunks
SPIN_TIMEOUT_S = 120.0      # the longest a call waits for its peers
INSTANCE = _build.Instance("peer_reduce", 0, 0)


@functools.cache
def _library() -> ctypes.CDLL:
    """``csrc/peer_reduce.cu``, built at its first use and loaded."""
    lib = _build.load(INSTANCE).lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.peer_alloc.argtypes = [i64, ctypes.POINTER(ptr), ptr]
    lib.peer_open.argtypes = [ptr, ctypes.POINTER(ptr)]
    lib.peer_host_word.argtypes = [ctypes.POINTER(ptr), ctypes.POINTER(ptr)]
    lib.peer_reduce.argtypes = [ctypes.POINTER(ptr), i32, i32, ptr, ptr, i64,
                                i64, i32, i64, ptr, ptr, i64, ptr]
    lib.peer_close.argtypes = [ptr]
    lib.peer_free.argtypes = [ptr, ptr]
    lib.peer_error_string.argtypes = [i32]
    lib.peer_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_error(lib, what, rc):
    return f"{what} failed: {lib.peer_error_string(rc).decode()}"


class PeerGroup:
    """This rank's side of one process group's peer-mapped buffers on one
    card: ``size`` and ``rank`` in the group, ``bases`` (every rank's
    buffer as this process maps it), ``state`` (the device epoch and error
    word) and the error word's host mirror."""

    def __init__(self, device, lib, bases, rank, host_error, mirror):
        self.device = device
        self.size, self.rank = len(bases), rank
        self.bases = (ctypes.c_void_p * self.size)(*bases)
        self.state = torch.zeros(2, dtype=torch.int64, device=device)
        self._host = host_error
        self._host_error = ctypes.c_int.from_address(host_error)
        self._mirror = mirror     # the host word's device address
        self._lib = lib
        self.reported = False     # check() raised for this group

    @property
    def failed(self) -> bool:
        """Whether a call of this rank timed out (read after a
        synchronisation: the device writes the word)."""
        return self._host_error.value != 0

    def close(self, group) -> None:
        """Unmap the peers' buffers and free this rank's (collective over
        ``group``): after every rank's calls have ended, and this rank's
        buffer only once no peer maps it."""
        torch.cuda.current_stream(self.device).synchronize()
        barrier = (lambda: dist.barrier(group=group)) if self.size > 1 \
            else (lambda: None)
        barrier()
        with torch.cuda.device(self.device):
            rcs = [self._lib.peer_close(b) for r, b in enumerate(self.bases)
                   if r != self.rank]
        barrier()
        with torch.cuda.device(self.device):
            rcs.append(self._lib.peer_free(self.bases[self.rank],
                                           self._host))
        rc = next((rc for rc in rcs if rc), 0)
        if rc:
            raise RuntimeError(_cuda_error(self._lib, "releasing the peer "
                                           "buffers", rc))


def _open_group(group, device):
    """Set up ``group`` on ``device`` (collective over the group): a
    :class:`PeerGroup`, or the reason the ranks cannot map each other's
    buffers, which every rank returns alike."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    handle, reason, lib = None, None, None
    if not torch.cuda.is_available():
        reason = "this process has no CUDA device"
    elif size > 32:
        reason = f"the peer all-reduce takes at most 32 ranks, not {size}"
    else:
        try:
            lib = _library()
            own, buf = ctypes.c_void_p(), ctypes.create_string_buffer(
                lib.peer_handle_bytes())
            nbytes = lib.peer_flag_bytes() + 2 * size * CAPACITY * 8
            with torch.cuda.device(device):
                rc = lib.peer_alloc(nbytes, ctypes.byref(own),
                                    ctypes.addressof(buf))
            if rc:
                reason = _cuda_error(lib, "cudaMalloc / cudaIpcGetMemHandle",
                                     rc)
            else:
                handle = buf.raw
        except (OSError, RuntimeError) as exc:
            reason = f"the kernel could not be built or loaded: {exc}"
    everyone = [None] * size
    dist.all_gather_object(everyone, (handle, reason), group=group)
    reasons = [f"rank {r}: {why}" for r, (_, why) in enumerate(everyone)
               if why]
    bases = []
    if not reasons:
        with torch.cuda.device(device):
            for r, (h, _) in enumerate(everyone):
                if r == rank:
                    bases.append(own.value)
                    continue
                ptr, buf = ctypes.c_void_p(), ctypes.create_string_buffer(
                    h, len(h))
                rc = lib.peer_open(ctypes.addressof(buf), ctypes.byref(ptr))
                if rc:
                    reason = _cuda_error(
                        lib, f"cudaIpcOpenMemHandle of rank {r}'s buffer", rc)
                    break
                bases.append(ptr.value)
        opened = [None] * size
        dist.all_gather_object(opened, reason, group=group)
        reasons = [f"rank {r}: {why}" for r, why in enumerate(opened) if why]
    if reasons:
        return ("the ranks of this group cannot map each other's memory, "
                "which the peer all-reduce needs (ranks of one host, on "
                "cards that reach each other): " + "; ".join(reasons))
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    with torch.cuda.device(device):
        rc = lib.peer_host_word(ctypes.byref(host), ctypes.byref(dev))
    if rc:
        raise RuntimeError(_cuda_error(lib, "cudaHostAlloc", rc))
    return PeerGroup(device, lib, bases, rank, host.value, dev.value)


# (group, device) -> PeerGroup, or why the group cannot be mapped.
_GROUPS: dict = {}


def setup(group, device):
    """Set up ``group``'s peer buffers on CUDA ``device`` if this process
    has not yet (collective over the group: every rank calls it alike).
    Returns None, or why its ranks cannot map each other's memory."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device()
                              if torch.cuda.is_available() else 0)
    key = (group, device)
    if key not in _GROUPS:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a process group's peer buffers are set up "
                               "eagerly, before any capture of its "
                               "collectives: make the mesh or the solver "
                               "first")
        _GROUPS[key] = _open_group(group, device)
    found = _GROUPS[key]
    return found if isinstance(found, str) else None


def check(*groups) -> None:
    """Raise if a call on one of ``groups`` (a solver's process groups)
    timed out since the last check: one synchronisation of each of their
    cards' current streams, then a read of each group's error word in host
    memory.  The sharded solvers call it after a solve, never during one.
    A group that failed stays failed: its later calls raise on the host."""
    mine = [g for (group, _), g in _GROUPS.items()
            if isinstance(g, PeerGroup) and any(group is h for h in groups)]
    for device in {g.device for g in mine}:
        torch.cuda.current_stream(device).synchronize()
    failed = [g for g in mine if g.failed and not g.reported]
    for g in failed:
        g.reported = True
    if failed:
        raise RuntimeError(
            f"a peer all-reduce waited more than {SPIN_TIMEOUT_S} s for its "
            f"peers (rank {failed[0].rank} of {failed[0].size}): a rank "
            "stopped or issued other collectives; the group's results since "
            "are NaN")


def release(*groups) -> None:
    """Free the peer buffers, mappings and error words of ``groups`` (every
    group this process set up when none is named), collective over each
    group: every rank calls it alike, once its calls on the group are done
    and before the group is destroyed.  A released group is set up anew at
    its next use."""
    keys = [key for key in _GROUPS
            if not groups or any(key[0] is g for g in groups)]
    for key in keys:
        found = _GROUPS.pop(key)
        if isinstance(found, PeerGroup):
            found.close(key[0])


def peer_reduce_ref(x, group, op):
    """Plain version: the exact gather, then the rank-ordered accumulation
    (a sum, or torch.maximum), as the kernel does.  ``x``: a 1-d tensor;
    returns (n,), or (P, n) for GATHER."""
    peer_reduce_ref.launches += 1
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = x.new_zeros((size, x.numel()))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    if op == GATHER:
        return buf
    acc = buf[0]
    for s in range(1, size):
        acc = acc + buf[s] if op == SUM else torch.maximum(acc, buf[s])
    return acc


_build.register(peer_reduce_ref, shapes=False)


def peer_reduce(x, group, op):
    """The sum (SUM) or the elementwise max (MAX) of ``x`` over the ranks
    of ``group``, or every rank's ``x`` in rank order (GATHER, (P, n)),
    every rank getting the same bits.  ``x``: a contiguous 1-d float64
    tensor, of the same length on every rank.  On a CUDA tensor the kernel
    (one launch a :data:`CAPACITY` chunk); on a CPU tensor the plain
    version."""
    if x.device.type == "cpu":
        return peer_reduce_ref(x, group, op)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    if x.dtype != torch.float64 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"the peer all-reduce takes a contiguous 1-d float64 "
                         f"tensor, not {x.dtype} of shape {tuple(x.shape)}")
    if op not in (SUM, MAX, GATHER):
        raise ValueError(f"unknown op {op!r}")
    refused = setup(group, x.device)
    if refused is not None:
        raise RuntimeError(refused)
    pg = _GROUPS[(group, x.device)]
    if pg.reported:
        raise RuntimeError("a call on this group timed out before "
                           "(parallel.peer.check): it has no results")
    n = x.numel()
    out = x.new_empty((pg.size, n) if op == GATHER else (n,))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    timeout_ns = int(SPIN_TIMEOUT_S * 1e9)
    for lo in range(0, n, CAPACITY):
        m = min(CAPACITY, n - lo)
        with torch.cuda.device(x.device):
            rc = pg._lib.peer_reduce(
                pg.bases, pg.size, pg.rank, x.data_ptr() + 8 * lo,
                out.data_ptr() + 8 * lo, m, n, op, CAPACITY,
                pg.state.data_ptr(), pg._mirror, timeout_ns, stream)
        if rc != 0:
            raise RuntimeError(_cuda_error(pg._lib, "peer_reduce launch",
                                           rc))
        _build.count_launches(peer_reduce, (pg.size, m))
    return out


_build.register(peer_reduce, shapes=True)
