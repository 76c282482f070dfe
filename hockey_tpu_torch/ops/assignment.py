"""Linear assignment for ByteTrack association: port of
hockey_tpu/ops/assignment.py (`auction_match`).

A Jacobi ("all bidders at once") auction over a (T, D) benefit matrix, then
a greedy fill of what is left, element for element the JAX solver. JAX
runs both loops as `lax.while_loop`s inside one compiled program; in eager
PyTorch every `while` test on a device value is a host sync, so:

- The auction tests its `while` condition after every round, as JAX does,
  and stops at `max_rounds` exactly.
- The greedy fill's admissible entries always form a full rectangle
  (rows that are admissible and unassigned, by columns that are admissible
  and unowned), and each fill step removes one row and one column of it,
  so the number of steps is min(rows, columns). That count is read in the
  same sync as the auction's last test, and the steps run with no further
  test. Each step is masked by the JAX loop's own condition (a step whose
  residual is all `_NEG` would otherwise pair row 0 with column 0).

So one association costs (auction rounds run + 1) host syncs; `stats`
counts them, and each is an `auction_sync` range around the read alone
(the launches of the condition's ops lie outside it). This eager solver is
the plain version that the CPU runs and that the tracker's CUDA kernel
(tracking/scan_kernel.py, csrc/tracker_scan.cu) repeats inside one launch
with no host sync; on CUDA tensors the tracker takes only the kernel, so
`stats` counts nothing there and the kernel keeps its own counters.

The body uses no `.item()`, boolean-mask indexing or `nonzero`;
`.at[...].set(mode="drop")` becomes a scatter into a buffer one slot
longer whose last slot is dropped. `torch.argmax` returns the first
maximum, as `jnp.argmax` does.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate

_NEG = -1e9
AUCTION_EPS = 2e-3       # the bid increment
AUCTION_MAX_ROUNDS = 96  # the auction's bound on its rounds


class AssignmentStats:
    """Counters of `auction_match`: host syncs (each read of the loop's
    condition from the device), auction rounds run and fill steps run.
    Callers set them to 0 and read them around the work they measure."""

    def __init__(self):
        self.syncs = 0
        self.rounds = 0
        self.fill_steps = 0


stats = AssignmentStats()


def _append(x: torch.Tensor, value: int) -> torch.Tensor:
    """x with one more slot, `value`: the target of a dropped scatter."""
    return torch.cat([x, x.new_full((1,), value)])


def _auction_round(b, prices, owner, assign, gave_up, eps, rows_t, cols):
    """One bidding round (hockey_tpu ops/assignment.py:62-86)."""
    t = assign.shape[0]
    values = b - prices[None, :]
    j1 = torch.argmax(values, dim=1)
    v1 = values.gather(1, j1[:, None])[:, 0]
    v2 = values.scatter(1, j1[:, None], _NEG).amax(dim=1)
    v2 = torch.clamp_min(v2, 0.0)  # unmatched is the outside option
    gave_up = gave_up | (v1 <= 0.0)
    bid = prices[j1] + (v1 - v2) + eps
    bidder = (assign < 0) & ~gave_up
    bid_mat = torch.where(bidder[:, None] & (j1[:, None] == cols[None, :]),
                          bid[:, None], _NEG)
    best_bid = bid_mat.amax(dim=0)
    best_row = torch.argmax(bid_mat, dim=0).to(torch.int32)
    won = best_bid > _NEG / 2
    # evict previous owners of re-auctioned columns, then seat the winners
    evict = torch.where(won & (owner >= 0), owner, rows_t).long()
    assign = _append(assign, -1).scatter(0, evict, -1)[:t]
    seat = torch.where(won, best_row, rows_t).long()
    assign = _append(assign, -1).scatter(
        0, seat, torch.where(won, cols.to(torch.int32), -1))[:t]
    owner = torch.where(won, best_row, owner)
    prices = torch.where(won, best_bid, prices)
    return prices, owner, assign, gave_up


def _status(b, owner, assign, gave_up) -> torch.Tensor:
    """(2,) int64 on the device: whether a row still bids (the auction's
    `while` condition without its round bound), and the greedy fill's step
    count if the auction stopped now."""
    resid_ok = ((assign < 0)[:, None] & (owner < 0)[None, :] & (b > _NEG / 2))
    n_fill = torch.minimum(resid_ok.any(dim=1).sum(), resid_ok.any(dim=0).sum())
    bidding = ((assign < 0) & ~gave_up).any()
    return torch.stack([bidding.long(), n_fill])


def auction_match(
    benefit: torch.Tensor,   # (T, D), e.g. IoU
    row_ok: torch.Tensor,    # (T,) bool
    col_ok: torch.Tensor,    # (D,) bool
    eps: float = AUCTION_EPS,
    max_rounds: int = AUCTION_MAX_ROUNDS,
) -> torch.Tensor:
    """Maximum-total-benefit bipartite matching (hockey_tpu
    ops/assignment.py:30-114). Returns (T,) int32: the column assigned to
    each row, -1 = unmatched. Masked rows and columns never match; no
    gating here."""
    t, d = benefit.shape
    dev = benefit.device
    b = torch.where(row_ok[:, None] & col_ok[None, :], benefit.float(), _NEG)
    can = (b > _NEG / 2).any(dim=1)

    prices = torch.zeros(d, dtype=torch.float32, device=dev)
    owner = torch.full((d,), -1, dtype=torch.int32, device=dev)
    assign = torch.full((t,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    cols = torch.arange(d, device=dev)
    rows_t = torch.full((), t, dtype=torch.int32, device=dev)
    # priced-out rows stop bidding: prices never fall
    gave_up = ~can

    it = 0
    while True:
        status = _status(b, owner, assign, gave_up)
        with annotate("auction_sync"):
            bidding, n_fill = status.tolist()
        stats.syncs += 1
        if not bidding or it >= max_rounds:
            break
        prices, owner, assign, gave_up = _auction_round(
            b, prices, owner, assign, gave_up, eps, rows_t, cols)
        it += 1
        stats.rounds += 1

    # greedy completion by descending benefit (ops/assignment.py:91-113)
    resid = torch.where((assign < 0)[:, None] & (owner < 0)[None, :], b, _NEG)
    flat_resid = resid.reshape(-1)
    for _ in range(min(n_fill, t, d)):
        flat = torch.argmax(flat_resid)
        go = flat_resid[flat] > _NEG / 2  # the JAX loop's condition
        i, j = flat // d, flat % d
        assign = torch.where(go & (rows == i), j.to(torch.int32), assign)
        kill = go & ((rows == i)[:, None] | (cols == j)[None, :])
        flat_resid = flat_resid.masked_fill(kill.reshape(-1), _NEG)
        stats.fill_steps += 1
    return assign
