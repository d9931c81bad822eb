"""Public attention entry points + KV page copy paths (port of
``repro.kernels.ops``).

The attention entry points dispatch on the tensor's device: a CUDA tensor
launches the hand-written Hopper kernel, a CPU tensor runs its plain version.

The page copy helpers move whole KV pages between the device page pool
(``[npages, page, ...]``, the buffer the paged decode kernel indexes through
block tables) and a host pool (a CPU tensor, pinned when the device is a
GPU). Where the reference donated the pool to XLA, these update the pool in
place and return it. Host<->device copies here are blocking: the host pool
is free to rewrite as soon as a call returns.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                  flash_attention_padded)
from repro_torch.kernels.prefill_attention import paged_chunk_attention

__all__ = ["flash_attention", "flash_attention_padded",
           "paged_decode_attention",
           "paged_chunk_attention", "gather_kv_pages",
           "scatter_kv_pages", "copy_pages_on_device", "copy_pages_to_host",
           "copy_pages_from_host", "pack_token_pages"]


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long).to(device)


def _distinct(ids: Sequence[int], what: str) -> None:
    # one batch may not write a frame twice: duplicate-index writes land in
    # no defined order
    if len(set(int(i) for i in ids)) != len(ids):
        raise ValueError(f"duplicate destination frames in one {what} batch")


def gather_kv_pages(pages: torch.Tensor, page_ids) -> torch.Tensor:
    """Read pages ``page_ids`` out of a ``[npages, page, ...]`` pool."""
    return pages.index_select(0, _ids(page_ids, pages.device))


def scatter_kv_pages(pages: torch.Tensor, page_ids,
                     values: torch.Tensor) -> torch.Tensor:
    """Write ``values`` (``[n, page, ...]``) into pool frames ``page_ids``,
    in place (the reference donated the pool for the same reason: no
    multi-GB rematerialization per migration batch). Returns the pool."""
    pages.index_copy_(0, _ids(page_ids, pages.device),
                      values.to(device=pages.device, dtype=pages.dtype))
    return pages


def pack_token_pages(k_all: torch.Tensor, v_all: torch.Tensor,
                     page_size: int, dtype=None) -> torch.Tensor:
    """Pack per-layer prefill KV into combined page values.

    ``k_all``/``v_all``: [L, S, vh, hd] (global layer order). Returns
    [n_pages, page, L, 2, vh, hd] — the trailing page is zero-padded past S
    (decode fills those slots later). One page holds every layer's K and V
    for ``page_size`` consecutive positions, the value layout of the
    engine's single physical page pool.
    """
    L, S, vh, hd = k_all.shape
    n = -(-S // page_size)
    dt = dtype or k_all.dtype
    out = torch.zeros((n * page_size, L, 2, vh, hd), dtype=dt,
                      device=k_all.device)
    out[:S, :, 0] = k_all.transpose(0, 1).to(dt)
    out[:S, :, 1] = v_all.transpose(0, 1).to(dt)
    return out.reshape(n, page_size, L, 2, vh, hd)


def copy_pages_on_device(pages: torch.Tensor, src_ids,
                         dst_ids) -> torch.Tensor:
    """Copy-on-write data plane: duplicate frames ``src_ids`` into frames
    ``dst_ids`` within the same pool, in place. The sources are gathered
    before the scatter, so src/dst lists may interleave freely as long as
    they are disjoint."""
    _distinct(dst_ids, "copy_pages_on_device")
    return scatter_kv_pages(pages, dst_ids, gather_kv_pages(pages, src_ids))


def copy_pages_to_host(device_pages: torch.Tensor, device_ids,
                       host_pool: torch.Tensor, host_ids) -> None:
    """Swap-out: device frames -> host pool slots (in place on the host
    side; the device pool is unchanged)."""
    if len(device_ids) == 0:
        return
    _distinct(host_ids, "copy_pages_to_host")
    got = gather_kv_pages(device_pages, device_ids).cpu()   # synchronizes
    host_pool[_ids(host_ids, "cpu")] = got


def copy_pages_from_host(host_pool: torch.Tensor, host_ids,
                         device_pages: torch.Tensor,
                         device_ids) -> torch.Tensor:
    """Swap-in: host pool slots -> device frames, in place. The gathered
    host rows are a fresh pageable tensor, so the upload completes before
    this returns. Returns the pool."""
    if len(device_ids) == 0:
        return device_pages
    _distinct(device_ids, "copy_pages_from_host")
    vals = host_pool.index_select(0, _ids(host_ids, "cpu"))
    return scatter_kv_pages(device_pages, device_ids,
                            vals.to(device_pages.device))
