"""The ring hop across processes: each rank writes its block into its right
neighbour's memory.

The cross-device form of the TPU kernel ``_hop_kernel``
(``ringpop_tpu/ops/gossip_remote_copy.py``), whose body is one remote DMA
into the right neighbour's buffer.  Here one process holds one shard (a
rank of a ``torch.distributed`` group, ``parallel.make_mesh(group=...)``),
and one hop moves every rank's tensors to rank (r + 1) mod D:

* on CUDA tensors, ``rp_peer_hop`` in ``csrc/ring_hop.cu`` copies them
  through a pointer that ``cudaIpcOpenMemHandle`` mapped into this process,
  straight into the neighbour's receive buffer: one launch a hop, counted
  in ``peer_hop.launches``.  The payload moves through that kernel only;
  the gloo group carries the buffers' handles and the barriers, never a
  CUDA payload;
* on CPU tensors, the plain version: a gloo ``isend`` to the right and a
  ``recv`` from the left.

Receive buffers (``PeerRing``): two slots a rank, used in turn, each from
the library's own ``cudaMalloc`` (a handle of a block of torch's caching
allocator would name its whole segment), seen by torch through
``__cuda_array_interface__``.  Their handles are exchanged over the gloo
group when they are made, and they are made again, by every rank at the
same hop, when a larger payload comes (every rank hops tensors of the same
shapes at the same point of the program).

Ordering, in place of the TPU kernel's barrier and send/recv semaphores:
each hop launches the write on the stream that made the sources (so it
follows them), synchronises that stream and meets the other ranks at a
gloo barrier (every write has landed), then copies the tensors out of
its own slot into fresh tensors.  The two slots make the barrier before
the write unneeded: hop h + 2 writes the slot that hop h filled, and a
rank enters the barrier of hop h + 1 only after its stream, and so its
copies out of that slot, drained.  No kernel waits on a flag that
another process writes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.distributed as dist

from ringpop_tpu_torch import _build

HANDLE_BYTES = 64  # CUDA_IPC_HANDLE_SIZE
_ALIGN = 256  # each tensor of a hop starts at a multiple of this in a slot
_MIN_SLOT = 1 << 20
MAX_SEGS = 8  # tensors in one launch (kMaxSegs in ring_hop.cu)

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("ring_hop")
        for name, args in (
            ("rp_peer_hop", [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
                             ctypes.c_void_p, ctypes.c_void_p]),
            ("rp_ipc_alloc", [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p)]),
            ("rp_ipc_free", [ctypes.c_int, ctypes.c_void_p]),
            ("rp_ipc_handle", [ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p]),
            ("rp_ipc_open", [ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
            ("rp_ipc_close", [ctypes.c_int, ctypes.c_void_p]),
            ("rp_ipc_handle_size", []),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        if lib.rp_ipc_handle_size() != HANDLE_BYTES:
            raise RuntimeError(f"CUDA IPC handles are {lib.rp_ipc_handle_size()} bytes, "
                               f"not {HANDLE_BYTES}")
        _lib = lib
    return _lib


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr``, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False), "version": 2,
        }


def _offsets(tensors: Sequence[torch.Tensor]) -> tuple[list[int], int]:
    """Each tensor's byte offset in a slot, and the bytes the hop needs."""
    offs, end = [], 0
    for t in tensors:
        offs.append(end)
        end += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offs, end


class PeerRing:
    """One rank's end of the ring: its receive slots, the right
    neighbour's slots mapped into this process, and the group that
    carries the handles and the barriers."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.capacity = 0
        self.local: list[int] = []  # this rank's slots (device pointers)
        self.remote: list[int] = []  # the right neighbour's slots, mapped here
        self.views: list[torch.Tensor] = []  # uint8 views of the local slots
        self.hops = 0

    # -- buffers -------------------------------------------------------------

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _release(self) -> None:
        lib, dev = _kernel(), self.device.index
        for ptr in self.remote:
            _build.check(lib.rp_ipc_close(dev, ctypes.c_void_p(ptr)), "cudaIpcCloseMemHandle")
        self.remote = []
        self.views = []
        # the neighbour has unmapped this rank's slots before they go
        dist.barrier(group=self.group)
        for ptr in self.local:
            _build.check(lib.rp_ipc_free(dev, ctypes.c_void_p(ptr)), "cudaFree")
        self.local = []
        self.capacity = 0

    # audit: allow=RPL001 the ring's ordering: the stream drains before each barrier
    def reserve(self, nbytes: int) -> None:
        """Slots of at least ``nbytes``: made again, collectively, when the
        payload outgrows them."""
        if nbytes <= self.capacity:
            return
        cap = max(_MIN_SLOT, self.capacity * 2, -(-nbytes // _MIN_SLOT) * _MIN_SLOT)
        torch.cuda.current_stream(self.device).synchronize()
        if self.local:
            self._release()
        lib, dev = _kernel(), self.device.index
        handles = bytearray()
        for _ in range(2):
            ptr = ctypes.c_void_p()
            _build.check(lib.rp_ipc_alloc(dev, cap, ctypes.byref(ptr)), "cudaMalloc")
            self.local.append(ptr.value)
            buf = ctypes.create_string_buffer(HANDLE_BYTES)
            _build.check(lib.rp_ipc_handle(dev, ptr, buf), "cudaIpcGetMemHandle")
            handles += buf.raw
        mine = torch.frombuffer(handles, dtype=torch.uint8)
        every = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(every, mine, group=self.group)
        right = bytes(every[(self.rank + 1) % self.size].numpy())
        for s in range(2):
            ptr = ctypes.c_void_p()
            h = right[s * HANDLE_BYTES:(s + 1) * HANDLE_BYTES]
            _build.check(lib.rp_ipc_open(dev, h, ctypes.byref(ptr)), "cudaIpcOpenMemHandle")
            self.remote.append(ptr.value)
        self.views = [torch.as_tensor(_DeviceBytes(p, cap), device=self.device)
                      for p in self.local]
        self.capacity = cap
        dist.barrier(group=self.group)

    def remote_view(self, slot: int) -> torch.Tensor:
        """uint8 view of the right neighbour's slot as mapped here (the
        library row of the hop's timing: ``copy_`` into it)."""
        return torch.as_tensor(_DeviceBytes(self.remote[slot], self.capacity),
                               device=self.device)

    def buffer_bytes(self) -> int:
        """Device bytes of this rank's receive slots (not counted by torch)."""
        return len(self.local) * self.capacity

    # audit: allow=RPL001 the ring's ordering: the stream drains before each barrier
    def close(self) -> None:
        if self.local:
            torch.cuda.current_stream(self.device).synchronize()
            dist.barrier(group=self.group)
            self._release()

    # -- the hop -------------------------------------------------------------

    # audit: allow=RPL001 the ring's ordering: the stream drains before the barrier
    def hop(self, tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """Every rank's ``tensors`` to its right neighbour; returns the
        left neighbour's, in fresh tensors.  CPU tensors take the plain
        version; CUDA tensors launch the kernel (counted in
        ``peer_hop.launches``) or raise."""
        if not tensors:
            return ()
        devs = {t.device.type for t in tensors}
        if devs == {"cpu"}:
            return peer_hop_plain(tensors, self)
        if devs != {"cuda"}:
            raise ValueError(f"a peer hop moves cpu or cuda tensors, not {sorted(devs)}")
        if len(tensors) > MAX_SEGS:
            raise ValueError(f"a peer hop moves at most {MAX_SEGS} tensors, not {len(tensors)}")
        srcs = [t.contiguous() for t in tensors]
        offs, need = _offsets(srcs)
        self.reserve(need)
        slot = self.hops % 2
        self.hops += 1
        self.write(srcs, offs, slot)
        peer_hop.launches += 1
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)
        view = self.views[slot]
        return tuple(
            view[o:o + s.numel() * s.element_size()].view(s.dtype).view(s.shape).clone()
            for s, o in zip(srcs, offs)
        )

    def write(self, srcs: Sequence[torch.Tensor], offs: Sequence[int], slot: int) -> None:
        """The launch alone: contiguous CUDA ``srcs`` into the right
        neighbour's ``slot`` at byte offsets ``offs``, on the current
        stream, with no ordering (``hop`` adds it)."""
        n = len(srcs)
        stream = torch.cuda.current_stream(self.device)
        rc = _kernel().rp_peer_hop(
            n, (ctypes.c_void_p * n)(*[t.data_ptr() for t in srcs]),
            (ctypes.c_longlong * n)(*offs),
            (ctypes.c_longlong * n)(*[t.numel() * t.element_size() for t in srcs]),
            ctypes.c_void_p(self.remote[slot]), ctypes.c_void_p(stream.cuda_stream))
        _build.check(rc, "peer_hop")


def peer_hop(tensors: Sequence[torch.Tensor], ring: PeerRing) -> tuple[torch.Tensor, ...]:
    """One rightward hop of ``tensors`` over ``ring``: see ``PeerRing.hop``."""
    return ring.hop(tensors)


peer_hop.launches = 0


def peer_hop_plain(tensors: Sequence[torch.Tensor], ring: PeerRing) -> tuple[torch.Tensor, ...]:
    """The plain version of a hop: each CPU tensor sent to the right
    neighbour with a gloo ``isend`` and the left neighbour's received
    with a ``recv``."""
    right = ring._global((ring.rank + 1) % ring.size)
    left = ring._global((ring.rank - 1) % ring.size)
    out = []
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError("the plain peer hop moves CPU tensors only")
        src = t.contiguous()
        got = torch.empty_like(src)
        req = dist.isend(src, dst=right, group=ring.group)
        dist.recv(got, src=left, group=ring.group)
        req.wait()
        out.append(got)
    return tuple(out)
