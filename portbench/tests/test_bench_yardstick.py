"""The yardstick's and the spans' own rules on the CPU: the blocked
operator's live slot pairs against a count pair by pair, and a span whose
entry point the program lacks."""

import itertools

import pytest
import torch

from portbench import trace, yardstick


def test_live_slot_pairs_match_a_direct_count():
    g = torch.Generator().manual_seed(3)
    n_cells, L = (4, 3, 5), (8.0, 6.0, 10.0)
    pos = (torch.rand((200, 3), generator=g) - 0.5) * torch.tensor(L)
    counts = yardstick._cell_counts(pos, L, n_cells)
    assert int(counts.sum()) == 200
    offsets = [(0, 0, 0)] + [o for o in itertools.product((-1, 0, 1),
                                                          repeat=3)
                             if o > (0, 0, 0)]
    cell = [tuple(int(x) for x in c) for c in
            torch.floor((pos / torch.tensor(L) + 0.5)
                        * torch.tensor(n_cells)).long()]
    direct = 0
    for i in range(200):
        for j in range(200):
            for o in offsets:
                nb = tuple((cell[i][d] + o[d]) % n_cells[d] for d in range(3))
                if nb != cell[j]:
                    continue
                if o == (0, 0, 0):
                    direct += i < j
                else:
                    direct += 1
    assert yardstick.live_slot_pairs(counts, offsets) == direct


def test_a_span_without_its_entry_point_raises(monkeypatch):
    monkeypatch.setitem(trace.SPANS, "prepare",
                        [("pse_tpu_torch.integrator", "BandedEngine.prepare_"),
                         ("pse_tpu_torch.integrator", "BandedEngine.prepare")])
    with pytest.raises(RuntimeError, match="prepare_"):
        with trace.Spans():
            pass


def test_an_inherited_method_is_wrapped_once():
    from pse_tpu_torch import integrator

    before = {k: dict(v.__dict__) for k, v in
              (("banded", integrator.BandedEngine),
               ("base", integrator._Engine))}
    with trace.Spans() as s:
        owners = [(o, a) for o, a, _ in s._saved]
        assert len(owners) == len(set(owners))
    after = {k: dict(v.__dict__) for k, v in
             (("banded", integrator.BandedEngine),
              ("base", integrator._Engine))}
    assert before == after
