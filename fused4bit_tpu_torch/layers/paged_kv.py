"""Paged INT4 KV cache: a shared page pool and per-slot page tables.

Counterpart of ``fused4bit_tpu/layers/paged_kv.py``, with the same bytes:

* ``k_pool``/``v_pool`` [P, H, page/2, D] u8, pair-packed as in the
  contiguous cache (position 2s' in the low nibble, 2s'+1 XOR 8 in the high);
* ``k_scale``/``k_zp``/``v_scale``/``v_zp`` [P, H, page] f32, per position;
* ``page_table`` [B, max_pages] i32, slot -> physical page ids, unused
  entries at page 0 (a valid page that no slot owns: parked writes land
  there and nothing live reads it);
* ``lengths`` [B] i32, the filled positions of each slot.

A slot pays for the pages its request needs instead of ``max_seq``
positions, so a pool sized below ``num_slots * max_seq`` serves as many
slots; the host-side allocator lives in ``serving.engine``. Attention reads
the pages through the table (kernel K3', ``ops.decode_attention``);
:meth:`PagedKVCache.dequantize` is the gathered golden view.

Unlike the JAX cache, which is immutable, this one is updated IN PLACE:
:meth:`append`, :meth:`assign_pages`, :meth:`reset_slot` and
:meth:`merge_slot` write into the existing tensors and return ``self``, and
:meth:`slice_slot` returns a batch-1 view that shares the pools and whose
table and length rows are views of this cache's.

Contract, kept by the serving engine: every ``append`` of a row lies inside
one page (``start % page + T <= page``). Decode steps always do; chunked
prefill does when ``page_size % prefill_bucket == 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .._device import resolve_device
from .kv_cache import QuantizedKVCache, _affine, _merge_packed, _update_positions

__all__ = ["PagedKVCache"]


@dataclasses.dataclass
class PagedKVCache:
    """INT4 KV cache over a shared page pool (see the module docstring)."""

    k_pool: torch.Tensor      # [P, H, page/2, D] u8 pair-packed
    v_pool: torch.Tensor
    k_scale: torch.Tensor     # [P, H, page] f32
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor
    page_table: torch.Tensor  # [B, max_pages] i32 (unused entries -> 0)
    lengths: torch.Tensor     # [B] i32
    window: int = 0           # > 0: a query sees the last ``window`` positions (a mask)

    _FIELDS = ("k_pool", "v_pool", "k_scale", "k_zp", "v_scale", "v_zp",
               "page_table", "lengths")
    _POOLS = _FIELDS[:6]

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, head_dim: int, *, num_pages: int,
             page_size: int, max_pages_per_slot: int,
             device: Optional[torch.device] = None, window: int = 0) -> "PagedKVCache":
        """An empty pool on ``device`` (None: the CUDA card). A ``window``
        masks the keys a query sees; the pages still hold every position."""
        if page_size % 2:
            raise ValueError(f"page_size={page_size} must be even (pair packing)")
        device = resolve_device(device)

        def z8():
            return torch.zeros((num_pages, num_kv_heads, page_size // 2, head_dim),
                               dtype=torch.uint8, device=device)

        def zf():
            return torch.zeros((num_pages, num_kv_heads, page_size), dtype=torch.float32,
                               device=device)

        return cls(z8(), z8(), zf(), zf(), zf(), zf(),
                   torch.zeros((batch, max_pages_per_slot), dtype=torch.int32, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device), window=window)

    # -- geometry ------------------------------------------------------------

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2] * 2

    @property
    def num_pages(self) -> int:
        return self.k_pool.shape[0]

    @property
    def max_pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        """Per-slot logical capacity (table width x page size)."""
        return self.max_pages_per_slot * self.page_size

    @property
    def head_dim(self) -> int:
        return self.k_pool.shape[3]

    @property
    def nbytes(self) -> int:
        """Bytes of the pools and scale planes (the table and lengths aside)."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self._POOLS)

    # -- slot management (the host-side allocator calls these) ---------------

    def assign_pages(self, slot: int, pages: Sequence[int]) -> "PagedKVCache":
        """Point a slot's table at ``pages`` (physical ids); entries beyond
        ``len(pages)`` are parked at page 0. The slot's length becomes 0."""
        pages = list(pages)
        if len(pages) > self.max_pages_per_slot:
            raise ValueError(
                f"{len(pages)} pages exceed the table width {self.max_pages_per_slot}"
            )
        row = torch.zeros((self.max_pages_per_slot,), dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self.page_table[slot].copy_(row)
        self.lengths[slot] = 0
        return self

    def reset_slot(self, slot: int) -> "PagedKVCache":
        """Mark a slot empty and park its table at page 0 (the host allocator
        takes its pages back)."""
        self.lengths[slot] = 0
        self.page_table[slot] = 0
        return self

    # -- engine seam: single-slot prefill ------------------------------------

    def slice_slot(self, slot: int) -> "PagedKVCache":
        """Batch-1 view: the SAME pool tensors, and the slot's table and
        length rows as views; a batch-1 prefill writes straight into the
        shared pool through the slot's own pages."""
        return dataclasses.replace(self, page_table=self.page_table[slot:slot + 1],
                                   lengths=self.lengths[slot:slot + 1])

    def merge_slot(self, part: "PagedKVCache", slot: int) -> "PagedKVCache":
        """Write a batch-1 cache back into ``slot``: pools that ``part`` does
        not share are copied whole, table and length rows are copied unless
        they are this slot's own views (a :meth:`slice_slot` view copies
        nothing)."""
        for f in self._POOLS:
            dst, src = getattr(self, f), getattr(part, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        for f in ("page_table", "lengths"):
            dst = getattr(self, f)[slot:slot + 1]
            src = getattr(part, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self

    # -- data path -----------------------------------------------------------

    def append(self, k: torch.Tensor, v: torch.Tensor,
               start: Optional[torch.Tensor] = None) -> "PagedKVCache":
        """Quantize and insert new steps through the page table, in place;
        returns ``self``.

        k, v: [B, H, T, D]; row b writes logical positions [start[b],
        start[b] + T), ``start`` defaulting to the row's length, inside the
        page ``page_table[b, start[b] // page]``. Each row's page is gathered,
        merged as in the contiguous cache and scattered back, all rows at
        once. Live slots own distinct pages; rows parked at page 0 may write
        it in any order, and a write whose page lies past the table lands
        there too, never in a live page.
        """
        page = self.page_size
        qk, ks, kz = _affine(k)
        qv, vs, vz = _affine(v)
        start = (self.lengths if start is None else start).to(self.lengths.device).long()
        new_lengths = (start + k.shape[2]).to(torch.int32)
        logical = torch.div(start, page, rounding_mode="floor")
        inside = logical < self.max_pages_per_slot
        pids = self.page_table.gather(
            1, logical.clamp(max=self.max_pages_per_slot - 1)[:, None])[:, 0].long()
        pids = torch.where(inside, pids, torch.zeros_like(pids))
        off = start - logical * page
        for pool, q in ((self.k_pool, qk), (self.v_pool, qv)):
            buf = pool.index_select(0, pids)                  # [B, H, page/2, D]
            _merge_packed(buf, q, off)
            pool.index_copy_(0, pids, buf)
        for plane, val in ((self.k_scale, ks), (self.k_zp, kz),
                           (self.v_scale, vs), (self.v_zp, vz)):
            rows = plane.index_select(0, pids)                # [B, H, page]
            _update_positions(rows, val, off)
            plane.index_copy_(0, pids, rows)
        self.lengths.copy_(new_lengths)
        return self

    def dequantize(self, dtype=torch.bfloat16):
        """Logical dense K, V [B, H, max_seq, D] gathered through the page
        table (positions past a slot's length are junk). The golden path; the
        kernel never builds this."""
        return self.logical().dequantize(dtype)

    def logical(self) -> QuantizedKVCache:
        """The logical content as a contiguous ``QuantizedKVCache`` of the
        same bytes, gathered through the table: codes [B, H, max_seq/2, D],
        planes [B, H, max_seq], and this cache's ``lengths`` tensor."""
        table = self.page_table.long()
        b, mp = table.shape

        def gather(t):  # [P, H, n, ...] -> [B, H, MP*n, ...] in logical order
            g = t[table].transpose(1, 2)                      # [B, H, MP, n, ...]
            return g.reshape(b, g.shape[1], mp * g.shape[3], *g.shape[4:])

        return QuantizedKVCache(*(gather(getattr(self, f)) for f in self._POOLS),
                                self.lengths, window=self.window)
