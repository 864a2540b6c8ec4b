"""Demand-loaded textures (counterpart of the JAX package's
``models/demand.py``, the reference's ``lib/DemandLoading`` paging system).

The device side is dense tensors and one request bitmap, with no page faults
and no sparse textures:

- ``DemandContext`` holds, on one device, a tile atlas ``(P, 64, 64, 3)`` of
  resident pages, a page table ``(total_pages,) int32`` from global tile id
  to atlas slot (-1 = not resident), each tile's mean colour (the
  always-resident fallback) and each texture's metadata row.
- ``demand_tex2d`` point-samples N texels with one flat gather from the
  atlas; a sample whose tile is not resident returns the tile's mean and
  ``resident=False``.
- ``page_requests`` folds the samples' page ids and resident flags into a
  ``(total_pages,)`` bool bitmap with one ``scatter_reduce(..., "amax")``
  over a uint8 tensor: the answer does not depend on the sample order.

The host side is ``DemandLoader``: the texture registry (plain and UDIM
textures), the page table and the atlas in host memory, tile fills on a
worker pool behind a ``Ticket``, LRU eviction when the atlas is full, and
``launch_prepare`` to upload what changed. The atlas tensor of a context is
updated in place by the next ``launch_prepare``, which also returns the new
page table: a context is valid until then.

Sampling is nearest-texel, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TILE = 64  # texels per tile edge


@dataclasses.dataclass(frozen=True)
class DemandContext:
    """The device side of the paging system."""

    atlas: torch.Tensor  # (P, TILE, TILE, 3) float32 resident pages
    page_table: torch.Tensor  # (total_pages,) int32 -> atlas slot | -1
    tile_mean: torch.Tensor  # (total_pages, 3) float32 fallback colour
    # (n_tex, 7) int32 [w, h, tiles_x, page_base, udim, vdim, sub_base]:
    # udim == 0 is a plain texture; else a UDIM grid whose (su, sv)
    # sub-image is texture sub_base + sv * udim + su
    tex_meta: torch.Tensor

    @property
    def total_pages(self) -> int:
        """The page table's length: every tile of every texture."""
        return self.page_table.shape[0]

    @property
    def num_pages(self) -> int:
        """The atlas's slots: the pages resident at once."""
        return self.atlas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.atlas.device


def _wrap01(x: torch.Tensor) -> torch.Tensor:
    """Wrap addressing: the fractional part."""
    return x - torch.floor(x)


def demand_tex2d(ctx: DemandContext, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor):
    """Point-sample texture ``tex_id`` (N,) at (u, v) (N,) -> (rgb (N, 3),
    resident (N,) bool, page_id (N,) int32). A sample whose tile is not
    resident gets the tile's mean colour; feed ``page_id`` and ``resident``
    to ``page_requests``."""
    meta = ctx.tex_meta[tex_id.to(torch.int64)]
    # a UDIM grid picks its sub-image by the integer cell of the wrapped
    # uv and samples it at the fractional coordinates
    udim, vdim, sub_base = meta[:, 4], meta[:, 5], meta[:, 6]
    is_udim = udim > 0
    uw = _wrap01(u) * torch.clamp(udim, min=1)
    vw = _wrap01(v) * torch.clamp(vdim, min=1)
    su = torch.minimum(uw.to(torch.int32), torch.clamp(udim - 1, min=0))
    sv = torch.minimum(vw.to(torch.int32), torch.clamp(vdim - 1, min=0))
    sub_id = torch.where(is_udim, sub_base + sv * udim + su,
                         tex_id.to(torch.int32))
    u = torch.where(is_udim, uw - su, u)
    v = torch.where(is_udim, vw - sv, v)
    meta = ctx.tex_meta[sub_id.to(torch.int64)]
    w, h, tiles_x, base = meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3]
    tx = torch.minimum((_wrap01(u) * w).to(torch.int32), w - 1)
    ty = torch.minimum((_wrap01(v) * h).to(torch.int32), h - 1)
    page = base + torch.div(ty, TILE, rounding_mode="floor") * tiles_x \
        + torch.div(tx, TILE, rounding_mode="floor")
    page64 = page.to(torch.int64)
    slot = ctx.page_table[page64]
    resident = slot >= 0
    idx = (torch.clamp(slot, min=0).to(torch.int64) * (TILE * TILE)
           + (ty % TILE).to(torch.int64) * TILE + (tx % TILE).to(torch.int64))
    texel = ctx.atlas.reshape(-1, 3)[idx]
    fallback = ctx.tile_mean[page64]
    rgb = torch.where(resident[:, None], texel, fallback)
    return rgb, resident, page


def fold_requests(req: torch.Tensor, page_id: torch.Tensor,
                  missing: torch.Tensor) -> torch.Tensor:
    """``req`` (total_pages,) uint8 with a 1 at each page in ``page_id``
    whose ``missing`` flag is set (an associative max, in place)."""
    return req.scatter_reduce_(0, page_id.to(torch.int64),
                               missing.to(torch.uint8), reduce="amax")


def page_requests(total_pages: int, page_id: torch.Tensor,
                  resident: torch.Tensor) -> torch.Tensor:
    """The request bitmap (total_pages,) bool: the pages sampled while not
    resident."""
    req = torch.zeros((total_pages,), dtype=torch.uint8,
                      device=page_id.device)
    return fold_requests(req, page_id, ~resident) > 0


class Ticket:
    """Completion handle of one ``process_requests``: -1 totals before
    processing starts; ``wait()`` joins the fill tasks and raises if one
    failed."""

    def __init__(self):
        self._total = -1
        self._remaining = -1
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.errors: list = []  # (page, exception) of failed fills

    def _start(self, total: int) -> None:
        with self._lock:
            self._total = total
            self._remaining = total
        if total == 0:
            self._done.set()

    def _task_done(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining == 0:
                self._done.set()

    def num_tasks_total(self) -> int:
        with self._lock:
            return self._total

    def num_tasks_remaining(self) -> int:
        with self._lock:
            return self._remaining

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._total == 0:
            return True
        ok = self._done.wait(timeout)
        if self.errors:
            raise RuntimeError(f"tile fills failed: {self.errors[:3]}")
        return ok


class DemandLoader:
    """The host side: texture registry, page table, LRU atlas and request
    processing on a worker pool; ``launch_prepare`` gives the context on
    ``device``."""

    def __init__(self, max_pages: int = 256, num_threads: int = 4,
                 device="cuda"):
        self.max_pages = max_pages
        self.device = torch.device(device)
        self._images: List[np.ndarray] = []
        # per-texture rows [w, h, tiles_x, page_base, udim, vdim, sub_base]
        self._meta: List[Tuple[int, ...]] = []
        self._total_pages = 0
        self._page_table: np.ndarray = np.zeros((0,), np.int32)
        self._tile_means: List[np.ndarray] = []
        self._atlas = np.zeros((max_pages, TILE, TILE, 3), np.float32)
        self._slot_page = np.full((max_pages,), -1, np.int64)  # slot -> page
        self._free: List[int] = list(range(max_pages))
        self._lru: Dict[int, int] = {}  # slot -> last-use stamp
        self._stamp = 0
        self._dirty_slots: set = set()
        self._table_dirty = True
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._dev: Optional[DemandContext] = None
        self.num_tiles_loaded = 0
        self.num_tiles_evicted = 0
        self.num_requests_processed = 0

    def create_texture(self, image: np.ndarray) -> int:
        """Register an (H, W, 3) float32 or uint8 image -> its texture id.
        No tile is resident at first."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        h, w = img.shape[0], img.shape[1]
        tiles_x = -(-w // TILE)
        tiles_y = -(-h // TILE)
        base = self._total_pages
        self._images.append(img)
        self._meta.append((w, h, tiles_x, base, 0, 0, 0))
        n = tiles_x * tiles_y
        self._total_pages += n
        self._page_table = np.concatenate(
            [self._page_table, np.full((n,), -1, np.int32)])
        # each tile's mean colour over its texels inside the image
        ph, pw = tiles_y * TILE, tiles_x * TILE
        padded = np.zeros((ph, pw, 3), np.float32)
        padded[:h, :w] = img
        cnt = np.zeros((ph, pw, 1), np.float32)
        cnt[:h, :w] = 1.0
        s = padded.reshape(tiles_y, TILE, tiles_x, TILE, 3).sum((1, 3))
        c = cnt.reshape(tiles_y, TILE, tiles_x, TILE, 1).sum((1, 3))
        self._tile_means.append(
            (s / np.maximum(c, 1.0)).reshape(n, 3).astype(np.float32))
        self._table_dirty = True
        return len(self._images) - 1

    def create_udim_texture(self, images, udim: int, vdim: int) -> int:
        """Register a UDIM grid of udim x vdim sub-images (row-major:
        ``images[sv * udim + su]``) -> the grid's texture id, which
        ``demand_tex2d`` resolves per (u, v) cell. Sub-images page
        independently."""
        assert len(images) == udim * vdim and udim > 0 and vdim > 0
        sub_base = len(self._images) + 1  # the ids after the grid's own
        grid_id = len(self._images)
        # the grid row owns no pages (tiles_x = 0)
        self._images.append(np.zeros((1, 1, 3), np.float32))
        self._meta.append((1, 1, 0, self._total_pages, udim, vdim, sub_base))
        self._tile_means.append(np.zeros((0, 3), np.float32))
        for img in images:
            self.create_texture(img)
        self._table_dirty = True
        return grid_id

    @property
    def total_pages(self) -> int:
        return self._total_pages

    @property
    def page_table(self) -> np.ndarray:
        """A copy of the host page table: page -> atlas slot, -1 = not
        resident."""
        return self._page_table.copy()

    @property
    def resident_pages(self) -> int:
        return int((self._page_table >= 0).sum())

    def launch_prepare(self) -> DemandContext:
        """Upload what changed (everything after a new texture or an
        eviction, else the filled atlas slots and the page table) -> the
        context on the loader's device."""
        dev = self.device
        if self._dev is None or self._table_dirty:
            means = (np.concatenate(self._tile_means) if self._tile_means
                     else np.zeros((0, 3), np.float32))
            # torch.tensor copies: the host arrays change under the fills
            self._dev = DemandContext(
                atlas=torch.tensor(self._atlas, device=dev),
                page_table=torch.tensor(self._page_table, device=dev),
                tile_mean=torch.tensor(means, device=dev),
                tex_meta=torch.tensor(
                    np.asarray(self._meta, np.int32).reshape(-1, 7),
                    device=dev),
            )
        elif self._dirty_slots:
            slots = np.asarray(sorted(self._dirty_slots), np.int64)
            self._dev.atlas[torch.from_numpy(slots).to(dev)] = (
                torch.from_numpy(self._atlas[slots]).to(dev))
            self._dev = dataclasses.replace(
                self._dev,
                page_table=torch.tensor(self._page_table, device=dev))
        self._dirty_slots.clear()
        self._table_dirty = False
        return self._dev

    def process_requests(self, request_bitmap) -> Ticket:
        """Fill the requested tiles on the worker pool -> a Ticket. Call
        ``launch_prepare()`` after ``ticket.wait()`` to upload them."""
        if isinstance(request_bitmap, torch.Tensor):
            request_bitmap = request_bitmap.cpu().numpy()
        req = np.asarray(request_bitmap)
        pages = [int(p) for p in np.nonzero(req)[0]
                 if self._page_table[p] < 0]
        # one batch at most fills the atlas; the rest re-request next frame
        pages = pages[: self.max_pages]
        ticket = Ticket()
        ticket._start(len(pages))
        self.num_requests_processed += len(pages)
        for page in pages:
            slot = self._alloc_slot()
            self._pool.submit(self._fill_tile, page, slot, ticket)
        return ticket

    def _alloc_slot(self) -> int:
        if self._free:
            return self._free.pop()
        victim = min(self._lru, key=self._lru.get)  # least recently used
        del self._lru[victim]
        old_page = self._slot_page[victim]
        if old_page >= 0:
            self._page_table[old_page] = -1
            self.num_tiles_evicted += 1
        self._table_dirty = True
        return victim

    def _tex_of_page(self, page: int) -> int:
        """The owning texture: the page-owning entry (tiles_x > 0) with the
        largest page_base <= page (UDIM grid rows own no pages)."""
        best = -1
        for i, m in enumerate(self._meta):
            if m[2] > 0 and m[3] <= page and (
                    best < 0 or m[3] > self._meta[best][3]):
                best = i
        if best < 0:
            raise KeyError(page)
        return best

    def _fill_tile(self, page: int, slot: int, ticket: Ticket) -> None:
        try:
            tex = self._tex_of_page(page)
            w, h, tiles_x, base = self._meta[tex][:4]
            ty, tx = divmod(page - base, tiles_x)
            img = self._images[tex]
            tile = np.zeros((TILE, TILE, 3), np.float32)
            y0, x0 = ty * TILE, tx * TILE
            sub = img[y0: y0 + TILE, x0: x0 + TILE]
            tile[: sub.shape[0], : sub.shape[1]] = sub
            self._atlas[slot] = tile
            self._page_table[page] = slot
            self._slot_page[slot] = page
            self._stamp += 1
            self._lru[slot] = self._stamp
            self._dirty_slots.add(slot)
            self.num_tiles_loaded += 1
        except Exception as e:  # raised at wait(): the pool drops it
            ticket.errors.append((page, e))
            self._free.append(slot)
        finally:
            ticket._task_done()

    def touch(self, pages) -> None:
        """Record the use of resident pages for the LRU."""
        if isinstance(pages, torch.Tensor):
            pages = pages.cpu().numpy()
        self._stamp += 1
        for p in np.asarray(pages).reshape(-1):
            s = self._page_table[int(p)]
            if s >= 0:
                self._lru[int(s)] = self._stamp
