"""The mesh's ``spatial`` axis: each image's rows split over processes.

Counterpart of the JAX package's ``spatial`` mesh axis
(``parallel/mesh.py:array_sharding`` there), where GSPMD shards H of every
NHWC activation and inserts the halo exchanges and the cross-shard
reductions itself. Here the S spatial peers of a data coordinate each hold
rows of every activation of the data coordinate's batch, and the modules
exchange rows explicitly through one autograd collective, ``exchange`` (an
all-to-all whose backward is the reverse all-to-all).

A row-sharded tensor is (B, n, W, C) with a ``Rows``: the global height H
and the spatial axis. Peer s holds rows [s·c, (s + 1)·c) ∩ [0, H), c =
ceil(H / S), as GSPMD pads a dim that does not divide: at a deep stage a
peer may hold fewer rows, or none (2 rows over 4 peers: 1, 1, 0, 0). The
image's H must divide by S (the JAX ``shard_batch``'s rule). On top of
``exchange``:

* ``fetch``: any rows each peer asks for (a conv's halo, a stride-s conv's
  rows on a new layout, a resize's source rows), zeros beyond the image;
* ``gather_rows`` / ``keep_rows``: every row on every peer, and a whole
  tensor's own rows;
* ``to_batch`` / ``from_batch``: the rows <-> batch all-to-all that runs the
  deformable attention on whole maps of B/S batch rows (the JAX program's
  batch-parallel hints over ("data", "spatial"));
* ``slab``: an X block's rows with the halo K3 spoils, grown to K3's
  8-row multiple;
* ``sum_over_peers``: a pooled sum over the peers' rows.

Gradients. A replicated tensor (the same values on every peer: the PPM's
bins, the classifier's pooled features and logits, the attention's maps
where the gather route computes them) holds on each peer the part of its
gradient that comes from that peer's rows, so every peer's gradient of
every parameter is a part, and the train step sums them over data ×
spatial (of the rank's model coordinate). The replicated loss (the classifier's) is weighted by 1/S for
that (``train/losses.py``); BatchNorm of a replicated tensor reduces over
the data group only (its backward is linear in the gradient, so the parts
stay parts). ``exchange``'s backward sends each row's gradient back to the
peer that holds the row, which sums them; ``sum_over_peers``' backward sums
the parts.

Every peer runs the same operations in the same order, only their sizes
differ: a peer with 0 rows of a conv's output convolves one row of what it
fetched and keeps none, so the autograd graphs match and the backward (and
a checkpointed stage's recompute) issues the collectives in one order on
every peer.

Beside the mesh's model axis (``parallel/model_axis.py``) a split module's
activations are row shards of this rank's channel slice (a split MLP's
hidden units, a split conv's outputs): ``fetch``, ``slab``, ``to_batch``
and ``from_batch`` move whatever channels they are given over the spatial
group, and the model peers of one spatial coordinate hold the same rows,
so the model group's collectives between them see equal shapes, a peer
with no rows included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import ModelAxis


@dataclass(frozen=True)
class Rows:
    """A row-sharded activation's layout: H global rows over ``axis``."""

    H: int
    axis: ModelAxis

    def span(self, s: int) -> Tuple[int, int]:
        """Peer s's rows [lo, hi)."""
        c = -(-self.H // self.axis.size)
        lo = min(s * c, self.H)
        return lo, min(lo + c, self.H)

    @property
    def lo(self) -> int:
        return self.span(self.axis.rank)[0]

    @property
    def hi(self) -> int:
        return self.span(self.axis.rank)[1]

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def at(self, H: int) -> "Rows":
        """The layout of H rows over the same axis."""
        return Rows(H, self.axis)


def image_rows(H: int, axis: ModelAxis) -> Rows:
    """The layout of an image (or label) of H rows: ``ValueError`` where S
    does not divide H (the JAX package's ``shard_batch`` refuses it)."""
    if H % axis.size:
        raise ValueError(f"image height {H} is not divisible by the spatial axis {axis.size}: "
                         "each spatial peer takes H / S rows")
    return Rows(H, axis)


def _all_to_all(pieces: Sequence[torch.Tensor], shapes: Sequence[Tuple[int, ...]],
                group) -> List[torch.Tensor]:
    """Piece t to peer t; from peer t a tensor of ``shapes[t]``."""
    ref = pieces[0]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.cat([p.reshape(-1) for p in pieces])
    out = ref.new_empty(sum(sizes))
    dist.all_to_all_single(out, flat, sizes, [p.numel() for p in pieces], group=group)
    return [t.view(s) for t, s in zip(out.split(sizes), shapes)]


class _Exchange(torch.autograd.Function):
    """``pieces[t]`` sent to spatial peer t, the peers' pieces for this
    rank received (of ``shapes``); the backward sends each received piece's
    gradient back."""

    @staticmethod
    def forward(ctx, group, shapes, *pieces):
        ctx.group = group
        ctx.shapes = [tuple(p.shape) for p in pieces]
        return tuple(_all_to_all(pieces, shapes, group))

    @staticmethod
    def backward(ctx, *grads):
        back = _all_to_all([g.contiguous() for g in grads], ctx.shapes, ctx.group)
        return (None, None) + tuple(back)


def exchange(pieces: Sequence[torch.Tensor], shapes: Sequence[Tuple[int, ...]],
             axis: ModelAxis) -> List[torch.Tensor]:
    """All-to-all over the spatial peers, differentiable: ``pieces[t]``
    goes to peer t, and from peer t comes a tensor of ``shapes[t]``."""
    return list(_Exchange.apply(axis.group, [tuple(s) for s in shapes], *pieces))


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo = max(a[0], b[0])
    return lo, max(lo, min(a[1], b[1]))


def fetch(x: torch.Tensor, rows: Rows, want: Callable[[int], Tuple[int, int]]) -> torch.Tensor:
    """Global rows [lo, hi) = ``want(rank)`` of the row-sharded ``x``
    (B, n, ...) on every peer, zeros outside [0, H): (B, hi - lo, ...).
    ``want`` is called for every peer (each must know what the others ask
    for); where every peer asks for its own rows nothing is exchanged."""
    S, me = rows.axis.size, rows.axis.rank
    spans = [rows.span(s) for s in range(S)]
    wants = [want(s) for s in range(S)]
    if wants == spans:
        return x
    lo_me = spans[me][0]
    sends = [_overlap(spans[me], w) if t != me else (lo_me, lo_me)
             for t, w in enumerate(wants)]
    pieces = [x[:, a - lo_me:b - lo_me] for a, b in sends]
    gets = [_overlap(spans[t], wants[me]) for t in range(S)]
    shapes = [(x.shape[0], (b - a) if t != me else 0) + tuple(x.shape[2:])
              for t, (a, b) in enumerate(gets)]
    got = exchange(pieces, shapes, rows.axis)
    got[me] = x[:, gets[me][0] - lo_me:gets[me][1] - lo_me]  # this peer's own, not sent
    lo, hi = wants[me]
    top, bottom = min(max(-lo, 0), hi - lo), min(max(hi - rows.H, 0), hi - lo)
    return torch.cat([x.new_zeros((x.shape[0], top) + tuple(x.shape[2:]))] + got + [
        x.new_zeros((x.shape[0], bottom) + tuple(x.shape[2:]))], dim=1)


def gather_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Every row of the row-sharded ``x`` on every peer: (B, H, ...)."""
    return fetch(x, rows, lambda s: (0, rows.H))


def keep_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """This peer's rows of a whole (replicated) ``x`` (B, H, ...); its
    gradient is zero on the other rows (the other peers hold theirs)."""
    return x[:, rows.lo:rows.hi]


def to_batch(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Row shards (B, n, W, C) -> whole maps of this peer's B / S batch
    rows (B / S, H, W, C): peer s takes batch rows [s·B/S, (s + 1)·B/S)."""
    S = rows.axis.size
    b = x.shape[0] // S
    pieces = [x[t * b:(t + 1) * b] for t in range(S)]
    shapes = [(b, hi - lo) + tuple(x.shape[2:]) for lo, hi in map(rows.span, range(S))]
    return torch.cat(exchange(pieces, shapes, rows.axis), dim=1)


def from_batch(y: torch.Tensor, rows: Rows) -> torch.Tensor:
    """``to_batch``'s inverse: whole maps of B / S batch rows -> row
    shards (B, n, W, C)."""
    S = rows.axis.size
    pieces = [y[:, lo:hi] for lo, hi in map(rows.span, range(S))]
    shapes = [(y.shape[0], rows.n) + tuple(y.shape[2:])] * S
    return torch.cat(exchange(pieces, shapes, rows.axis), dim=0)


SLAB_MULTIPLE = 8  # K3's rows (the JAX gate's H % 8)


def slab_span(rows: Rows, s: int, halo: int) -> Tuple[int, int]:
    """Peer s's slab for K3: its rows and ``halo`` more on each side,
    clipped to the image (where K3's zero padding is the image's own),
    then grown within the image to a multiple of ``SLAB_MULTIPLE`` (H is
    one, by the gate)."""
    lo, hi = rows.span(s)
    a, b = max(lo - halo, 0), min(hi + halo, rows.H)
    grow = -(b - a) % SLAB_MULTIPLE
    b2 = min(rows.H, b + grow)
    return a - (grow - (b2 - b)), b2


def slab(x: torch.Tensor, rows: Rows, halo: int) -> Tuple[torch.Tensor, slice]:
    """(this peer's slab (``slab_span``) of the row-sharded ``x``, the
    slice of the slab's rows that are this peer's): K3 runs on the slab,
    its rows within ``halo`` of the slab's inner edges are spoiled by its
    zero padding, and the kept rows are not."""
    a, _ = slab_span(rows, rows.axis.rank, halo)
    return (fetch(x, rows, lambda s: slab_span(rows, s, halo)),
            slice(rows.lo - a, rows.hi - a))


class _SumOverPeers(torch.autograd.Function):
    """The sum over the spatial peers; the backward sums the parts of the
    (replicated) sum's gradient that each peer holds."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.contiguous().clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def sum_over_peers(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` (each peer's sum over its rows) summed over the spatial
    peers: replicated."""
    return _SumOverPeers.apply(x, axis)
