"""prompt_tok_s: prompt tokens prefilled by the ticks that ended inside the
window, over the window's seconds."""


def read(rec, spec):
    return sum(t.prefill_tokens for t in rec.ticks if rec.in_window(t.t1)) / rec.window_s
