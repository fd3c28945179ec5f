"""K6, the halo gather of the row-partitioned feature table: its wrapper,
plain version and launch counter, and the CUDA IPC calls that map a peer
rank's shard into this process.

    wrapper        replaces (taxoexpan_tpu/parallel/halo.py)
    halo_gather    K6: ring_exchange (:195, _ring_kernel :69)

The kernel is `ops/csrc/halo.cu`, whose header states what bounds it on an
H100 and why it pulls rows through mapped pointers instead of pushing
requests and answers around a ring. Given P equal shards [rows, D] (float32
or bf16) and req [P, cap] int32 of local slots bucketed by owner, it
returns ans [P, cap, D] float32 with ans[j, r] = shard_j[req[j, r]], and
zeros where the slot lies outside the shard (the dedup padding slots of
`parallel/partition.py`), which it never reads.

Dispatch is by the device of `req`: on the CPU the wrapper runs its plain
version over a list of CPU shard tensors; on CUDA it launches the kernel
over a `Shards` pointer table (or a list of CUDA shard tensors of this
process, from which it builds one) or raises. `halo_gather.launches`
counts kernel launches only. The gather has no backward: the feature table
is an input of the train step, not a parameter.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_build
from .launch import I, P, on_cuda, raise_on, stream

LL = ctypes.c_longlong
ULL = ctypes.c_ulonglong
_PP = ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {
    "halo_gather": ([P, I, LL, I, P, LL, P, I, I, P], I),
    "halo_error_string": ([I], ctypes.c_char_p),
    "halo_alloc": ([ULL, _PP], I),
    "halo_free": ([P], I),
    "halo_copy_in": ([P, P, ULL], I),
    "halo_ipc_handle_size": ([], I),
    "halo_ipc_handle": ([P, P], I),
    "halo_ipc_open": ([P, _PP], I),
    "halo_ipc_close": ([P], I),
}
DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    return cuda_build.load("halo", SIGNATURES)


@dataclass(frozen=True)
class Shards:
    """The P equal row shards [rows, D] of one table as K6 reads them: a
    device array of their base pointers. `owners` keeps alive what holds
    the memory when it is this process's (tensors); IPC mappings are owned
    by `parallel/halo.py:RingExchange`."""
    ptrs: torch.Tensor      # int64 [P] on the card
    rows: int
    d: int
    dtype: torch.dtype
    align: int              # the bytes every base pointer is aligned to
    owners: tuple = ()

    @property
    def p(self) -> int:
        return self.ptrs.shape[0]


def _alignment(ptrs) -> int:
    return min((ptr & -ptr) if ptr else 1 << 30 for ptr in ptrs)


def pointer_table(ptrs: list[int], rows: int, d: int, dtype: torch.dtype,
                  device: torch.device, owners: tuple = ()) -> Shards:
    if dtype not in DTYPES:
        raise TypeError(f"K6 takes float32 or bfloat16 shards, not {dtype}")
    return Shards(torch.tensor(ptrs, dtype=torch.int64, device=device),
                  int(rows), int(d), dtype, _alignment(ptrs), owners)


def local_shards(tensors) -> Shards:
    """The pointer table of P shard tensors of this process on one card."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype or \
                tuple(t.shape) != tuple(first.shape) or t.dim() != 2:
            raise ValueError("K6 shards must be equal [rows, D] tensors of "
                             "one dtype on one device")
        if not t.is_contiguous():
            raise ValueError("K6 shards must be contiguous")
    return pointer_table([t.data_ptr() for t in tensors], first.shape[0],
                         first.shape[1], first.dtype, first.device,
                         tuple(tensors))


# ------------------------------------------------------------ plain version

def halo_gather_plain(shards, req: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `shards` a list of P [rows, D] tensors,
    req [P, cap] -> ans [P, cap, D] float32, zero rows where a slot is out
    of range."""
    p, cap = req.shape
    if len(shards) != p:
        raise ValueError(f"req has {p} buckets for {len(shards)} shards")
    out = []
    for j, shard in enumerate(shards):
        slots = req[j].long()
        rows = shard.shape[0]
        valid = (slots >= 0) & (slots < rows)
        got = shard[slots.clamp(0, max(rows - 1, 0))].float() if rows else \
            torch.zeros((cap, shard.shape[1]), device=req.device)
        out.append(torch.where(valid[:, None], got, torch.zeros_like(got)))
    return torch.stack(out)


# ------------------------------------------------------------------ launch

def _vec(shards: Shards, ans: torch.Tensor) -> int:
    """Values a lane moves at once: the widest of 4, 2, 1 that divides D
    and keeps every shard base, ans and every row aligned."""
    elem = 4 if shards.dtype == torch.float32 else 2
    ans_align = _alignment([ans.data_ptr()])
    for vec in (4, 2, 1):
        if shards.d % vec == 0 and shards.align % (vec * elem) == 0 and \
                ans_align % (vec * 4) == 0:
            return vec
    return 1


def halo_gather(shards, req: torch.Tensor) -> torch.Tensor:
    """K6: ans [P, cap, D] float32 of the rows req [P, cap] names in each
    owner's shard (zeros for out-of-range slots). CPU: `shards` is a list
    of CPU tensors, or a `Shards` table of this process's tensors (plain
    version). CUDA: a `Shards` table, or a list of this process's CUDA
    shard tensors."""
    if not on_cuda(req, "halo_gather"):
        return halo_gather_plain(
            shards.owners if isinstance(shards, Shards) else shards, req)
    table = shards if isinstance(shards, Shards) else local_shards(shards)
    if req.dim() != 2 or req.shape[0] != table.p:
        raise ValueError(f"req has shape {tuple(req.shape)}, expected "
                         f"[{table.p}, cap]")
    if req.dtype != torch.int32 or not req.is_contiguous():
        raise TypeError("req must be contiguous int32")
    if req.device != table.ptrs.device:
        raise ValueError(f"req is on {req.device}, the shard table on "
                         f"{table.ptrs.device}")
    cap = req.shape[1]
    ans = torch.empty((table.p, cap, table.d), dtype=torch.float32,
                      device=req.device)
    if ans.numel() == 0:
        return ans
    lib = _lib()
    with torch.cuda.device(req.device):
        rc = lib.halo_gather(table.ptrs.data_ptr(), table.p, table.rows,
                             table.d, req.data_ptr(), cap, ans.data_ptr(),
                             4 if table.dtype == torch.float32 else 2,
                             _vec(table, ans), stream(req))
    raise_on(lib, rc, "halo_gather", "halo_error_string")
    halo_gather.launches += 1
    return ans


WRAPPERS = {"halo_gather": halo_gather}
halo_gather.launches = 0


# --------------------------------------------------------------- CUDA IPC

def _check(rc: int, what: str) -> None:
    raise_on(_lib(), rc, what, "halo_error_string")


def alloc_shard(host: torch.Tensor, device: torch.device) -> int:
    """A device copy of the CPU tensor `host` in an allocation of its own
    (so that its IPC handle maps exactly the shard); returns the pointer,
    to be freed with `free`."""
    host = host.contiguous()
    nbytes = host.numel() * host.element_size()
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(_lib().halo_alloc(max(nbytes, 1), ctypes.byref(ptr)),
               "cudaMalloc of a shard")
        _check(_lib().halo_copy_in(ptr, host.data_ptr(), nbytes),
               "copy of a shard to the card")
    return ptr.value


def free(ptr: int, device: torch.device) -> None:
    with torch.cuda.device(device):
        _check(_lib().halo_free(ptr), "cudaFree of a shard")


def ipc_handle(ptr: int, device: torch.device) -> bytes:
    """The IPC handle of an allocation made by `alloc_shard`."""
    buf = ctypes.create_string_buffer(_lib().halo_ipc_handle_size())
    with torch.cuda.device(device):
        _check(_lib().halo_ipc_handle(ptr, buf), "cudaIpcGetMemHandle")
    return buf.raw


def ipc_open(handle: bytes, device: torch.device) -> int:
    """Map a peer's allocation into this process; close with `ipc_close`."""
    buf = ctypes.create_string_buffer(handle, len(handle))
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(_lib().halo_ipc_open(buf, ctypes.byref(ptr)),
               "cudaIpcOpenMemHandle")
    return ptr.value


def ipc_close(ptr: int, device: torch.device) -> None:
    with torch.cuda.device(device):
        _check(_lib().halo_ipc_close(ptr), "cudaIpcCloseMemHandle")
