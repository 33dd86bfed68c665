"""The destination-tile plan of the backward kernels K2/K2b and K4, in plain
PyTorch, and the CUDA plan's bindings.

``csrc/dest_tiles.cuh`` says what the plan is: the live contributions of a
backward kernel sorted, stably, by the output tile of their tap base (plus
a sub-key for the tile's last row and column), so a block that owns a tile
of outputs reads the runs of the bases that reach it in a fixed order. The
plain version computes the same integers with ``bincount``, ``cumsum`` and a
stable ``argsort``; the card compares the two element for element.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MIN_CHUNK = 256       # csrc/dest_tiles.cuh kMinChunk


@dataclass(frozen=True)
class Grid:
    """Output tiles of ``ty`` x ``tx`` cells over ``n_img`` images of ``h``
    x ``w`` cells (K4: voxel columns of a frameset; K2: pixels of a
    camera)."""
    n_img: int
    h: int
    w: int
    ty: int
    tx: int

    @property
    def nty(self) -> int:
        return -(-self.h // self.ty)

    @property
    def ntx(self) -> int:
        return -(-self.w // self.tx)

    @property
    def n_tiles(self) -> int:
        return self.n_img * self.nty * self.ntx

    @property
    def n_keys(self) -> int:
        return self.n_img * (self.nty + 1) * (self.ntx + 1) * 4

    @property
    def max_chunks(self) -> int:
        return self.n_tiles + self.n_tiles // 2 + 1

    @property
    def max_slots(self) -> int:
        return self.n_tiles // 2 + 16

    def key_tile(self, img, ky, kx):
        return ((img * (self.nty + 1) + ky) * (self.ntx + 1) + kx) * 4

    def keys(self, img: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
        """The key of each base (by, bx >= -1) of image img; ``n_keys``
        where not live."""
        ky, kx = torch.div(by, self.ty, rounding_mode="floor"), torch.div(
            bx, self.tx, rounding_mode="floor")
        sub = ((by - ky * self.ty == self.ty - 1).long() * 2
               + (bx - kx * self.tx == self.tx - 1).long())
        key = self.key_tile(img.long(), ky + 1, kx + 1) + sub
        return torch.where(live, key, self.n_keys)

    def runs(self, start: torch.Tensor):
        """[n_tiles, 5] first sorted position and length of each run a
        tile reads, in order: its own key tile, the one below (sub-keys
        2-3), the one to the left (1, then 3), the diagonal one (3)."""
        t = torch.arange(self.n_tiles)
        ox, oy = t % self.ntx, (t // self.ntx) % self.nty
        img = t // (self.ntx * self.nty)
        own = self.key_tile(img, oy + 1, ox + 1)
        below = self.key_tile(img, oy, ox + 1)
        left = self.key_tile(img, oy + 1, ox)
        diag = self.key_tile(img, oy, ox)
        lo = torch.stack([own, below + 2, left + 1, left + 3, diag + 3], 1)
        hi = torch.stack([own + 4, below + 4, left + 2, left + 4, diag + 4], 1)
        start = start.long().cpu()
        return start[lo], start[hi] - start[lo]


@dataclass
class Plan:
    """order [n] int32: item indices by key, stable (the live ones first);
    start [n_keys + 1] int32: the first position of each key (start[-1] is
    the live count); chunk_off, slot_off [n_tiles + 1] int32: each tile's
    first work item and first scratch slot (prefixes); params [2] int32:
    (chunk length, scratch slots used)."""
    order: torch.Tensor
    start: torch.Tensor
    chunk_off: torch.Tensor
    slot_off: torch.Tensor
    params: torch.Tensor

    def fields(self):
        return {"order": self.order, "start": self.start,
                "chunk_off": self.chunk_off, "slot_off": self.slot_off,
                "params": self.params}


def _exclusive(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def plan_plain(keys: torch.Tensor, grid: Grid) -> Plan:
    """The plan of ``csrc/dest_tiles.cuh`` from keys [n] (in [0, n_keys],
    n_keys = dead), in plain PyTorch on the keys' device."""
    keys = keys.long()
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=grid.n_keys + 1)[:grid.n_keys]
    start = _exclusive(counts)
    _, lens = grid.runs(start)
    totals = lens.sum(1)
    nt = grid.n_tiles
    chunk = max(MIN_CHUNK, 2 * -(-int(totals.sum()) // max(nt, 1)))
    k = torch.clamp(-(-totals // chunk), min=1)
    slots = torch.where(k > 1, k, 0)
    if int(slots.sum()) > grid.max_slots:
        k, slots, chunk = torch.ones_like(k), torch.zeros_like(k), 2 ** 31 - 1
    i32 = dict(dtype=torch.int32, device=keys.device)
    return Plan(order.to(**i32), start.to(**i32), _exclusive(k).to(**i32),
                _exclusive(slots).to(**i32),
                torch.tensor([chunk, int(slots.sum())], **i32))


def tile_items(plan: Plan, grid: Grid, t: int):
    """The item indices tile t reads, in the kernels' order, cut in its
    chunks: [chunk 0's items, chunk 1's, ...]."""
    beg, lens = grid.runs(plan.start)
    order = plan.order.long().cpu()
    items = torch.cat([order[b:b + n] for b, n in zip(beg[t].tolist(),
                                                      lens[t].tolist())])
    k = int(plan.chunk_off[t + 1] - plan.chunk_off[t])
    chunk = int(plan.params[0])
    return [items[c * chunk:(c + 1) * chunk] for c in range(k)]


def new_plan(n: int, grid: Grid, device) -> tuple:
    """Empty CUDA tensors for a plan of n items and its workspace: the keys
    [n], then ``tiles::workspace_ints``."""
    def ints(k):
        return torch.empty(k, dtype=torch.int32, device=device)
    blocks = -(-n // 2048)
    hist = 256 * blocks
    ws = ints(5 * n + hist + -(-hist // 2048))
    plan = Plan(ints(n), ints(grid.n_keys + 1), ints(grid.n_tiles + 1),
                ints(grid.n_tiles + 1), ints(2))
    return plan, ws


def check_plan(plan: Plan, grid: Grid, n: int, device) -> None:
    """Raise unless ``plan`` has the sizes, dtype and device of a plan of n
    items over ``grid`` (a kernel indexes its tensors by the grid's tiles
    and keys). Its values are not read: that would wait for the card."""
    sizes = {"order": n, "start": grid.n_keys + 1,
             "chunk_off": grid.n_tiles + 1, "slot_off": grid.n_tiles + 1,
             "params": 2}
    for name, t in plan.fields().items():
        if (t.shape != (sizes[name],) or t.dtype != torch.int32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"plan.{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: expected ({sizes[name]},) int32 "
                             f"on {device}")


def plan_pointers(plan: Plan, ws: torch.Tensor):
    return (ws.data_ptr(), plan.order.data_ptr(), plan.start.data_ptr(),
            plan.chunk_off.data_ptr(), plan.slot_off.data_ptr(),
            plan.params.data_ptr())
