"""Faults planted in the program's timed path, to show that the check
catches them; not used by the benchmark's runs.

Each fault takes ``patch`` (anything with pytest's
``monkeypatch.setattr(obj, name, value)``, such as ``Patcher``) and the
cell's ``Spec``, and breaks the path underneath before the engine is
built, so that graphs captured in set-up hold it too.  ``applies(name,
spec)`` says whether the cell can have the fault: a ring offset needs
sliding-window rings.  One chip: there is no exchange between chips to
leave out.
"""

from __future__ import annotations

import torch


class Patcher:
    """``setattr`` that ``undo()`` reverts, in reverse order."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name: str, value) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def altered_token(patch, spec) -> None:
    """Every token altered where it is produced."""
    import torch_bnb_fp4_tpu_torch.serve.engine as E

    select = E.select
    patch.setattr(E, "select", lambda *a, **k: (select(*a, **k) + 1) % spec.geometry.vocab)


def altered_slot(patch, spec) -> None:
    """The tokens of decode slot 0 alone altered where they are produced;
    every other slot, and every prefill's first token, as the program
    makes them."""
    import torch_bnb_fp4_tpu_torch.serve.engine as E

    select = E.select

    def one_slot(*a, **k):
        tok = select(*a, **k)
        if tok.shape[0] == 1:  # a prefill's first token
            return tok
        slot0 = torch.arange(tok.shape[0], device=tok.device) == 0
        return torch.where(slot0, (tok + 1) % spec.geometry.vocab, tok)

    patch.setattr(E, "select", one_slot)


def unchanged_state(patch, spec) -> None:
    """A decode step that returns the cache's state unchanged: its writes
    are forgotten."""
    import torch_bnb_fp4_tpu_torch.serve.engine as E

    decode = E.Engine._decode_fn

    def frozen(self, bp, n):
        saved = self.cache.length.clone()
        decode(self, bp, n)
        self.cache.length.copy_(saved)

    patch.setattr(E.Engine, "_decode_fn", frozen)


def half_batch(patch, spec) -> None:
    """Decode over half of the batch's slots; the rest keep their tokens."""
    import torch_bnb_fp4_tpu_torch.serve.engine as E

    decode = E.Engine._decode_fn
    patch.setattr(E.Engine, "_decode_fn", lambda self, bp, n: decode(self, max(bp // 2, 1), n))


def _ring(spec) -> tuple[int, int]:
    """(ring rows, chunk) of the cell's sliding-window layers; rows equal
    to ``max_len`` when the cell keeps no rings."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    eng = spec.traffic["engine"]
    chunk = eng.get("prefill_chunk", 0) if eng.get("sliding_kv") else 0
    return T.ring_rows(eng["max_len"], spec.geometry.window, chunk), chunk


def ring_offset(patch, spec) -> None:
    """A ring's slots read one chunk older than the positions they hold:
    the chunk being written sees its own later keys, and the window's
    oldest chunk falls out of it."""
    from torch_bnb_fp4_tpu_torch.models import transformer as T

    ring, chunk = _ring(spec)
    positions = T.kv_slot_positions

    def shifted(new_len, rows):
        p, ok = positions(new_len, rows)
        if rows != ring:
            return p, ok
        p = p - chunk
        return p, p >= 0

    patch.setattr(T, "kv_slot_positions", shifted)


FAULTS = {f.__name__: f for f in (altered_token, altered_slot, unchanged_state, half_batch, ring_offset)}


def applies(name: str, spec) -> bool:
    if name == "ring_offset":
        return _ring(spec)[0] < spec.traffic["engine"]["max_len"]
    return name in FAULTS
