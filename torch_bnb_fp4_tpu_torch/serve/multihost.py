"""Multi-process serving: HTTP on rank 0, the engine loop in lockstep on
every rank.

Counterpart of ``torch_bnb_fp4_tpu/serve/multihost.py``.  With a mesh every
rank runs the Engine's host loop, and every rank must call
``submit``/``abort``/``step`` with the same arguments in the same order (its
forwards are collectives).  So:

  * rank 0 runs the normal :class:`EngineServer` HTTP front-end and, at the
    top of every engine tick, broadcasts the tick's newly accepted requests
    and abort uids to every rank (``dist.broadcast_object_list`` over the
    mesh's gloo control group, which carries them even when the tensors go
    over NCCL);
  * every other rank runs :func:`follow`, which blocks on the same
    broadcast, applies the identical submissions and steps its engine;
  * the broadcast is the tick's barrier: an idle rank 0 parks in its
    submission queue (at most ``idle_poll_s``) before broadcasting an empty
    tick, so followers never spin.  Rejections are deterministic, so every
    rank rejects the same requests.
"""

from __future__ import annotations

import logging
import queue

import torch.distributed as dist

from .engine import Engine
from .server import EngineServer

log = logging.getLogger("torch_bnb_fp4_tpu_torch.serve.multihost")


def _broadcast_blob(obj, group=None):
    """``obj`` of rank 0 (pickled by torch) on every rank of ``group``."""
    buf = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(buf, src=0, group=group)
    return buf[0]


def _busy(engine: Engine) -> bool:
    return bool(engine.pending or any(r is not None for r in engine.slot_req) or engine._pf is not None)


class MultihostEngineServer(EngineServer):
    """EngineServer for rank 0 of a meshed engine: each tick's submissions and
    aborts are broadcast so the follower ranks stay in lockstep.  Construct
    only on rank 0; run :func:`follow` on every other rank."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 8000, tokenizer=None,
                 idle_poll_s: float = 0.2):
        if dist.get_rank() != 0:
            raise RuntimeError("the HTTP front-end lives on rank 0; other ranks run follow(engine)")
        if engine.mesh is None:
            raise ValueError("MultihostEngineServer needs an engine built with a mesh")
        super().__init__(engine, host, port, tokenizer=tokenizer)
        self._idle_poll_s = idle_poll_s

    def _fail(self, uid: int, err: str) -> None:
        p = self._pending.pop(uid, None)
        if p is not None:
            p.error = err
            if p.stream_q is not None:
                p.stream_q.put(None)
            p.done.set()

    def _engine_tick(self) -> None:
        reqs = []
        try:
            req = self._subq.get(timeout=0.0 if self._busy() else self._idle_poll_s)
            while True:
                reqs.append(req)
                req = self._subq.get_nowait()
        except queue.Empty:
            pass
        aborts = []
        while not self._abortq.empty():
            try:
                aborts.append(self._abortq.get_nowait())
            except queue.Empty:
                break
        # one broadcast per tick, even when empty: it is the tick's barrier
        _broadcast_blob({"reqs": reqs, "aborts": [u for u, _ in aborts], "stop": False}, self.engine.mesh.ctrl_group)
        for req in reqs:
            try:
                self.engine.submit(req)
            except ValueError as e:  # deterministic: the followers reject it too
                self._fail(req.uid, str(e))
        for uid, holder in aborts:
            holder["aborted"] = self.engine.abort(uid)
            holder["done"].set()
        if self._busy():
            self.engine.step()
        comps = self.engine.completions
        while self._consumed < len(comps):
            c = comps[self._consumed]
            self._consumed += 1
            p = self._pending.pop(c.uid, None)
            if p is not None:
                p.completion = c
                if p.stream_q is not None:
                    p.stream_q.put(None)
                p.done.set()
        if self._consumed >= 256:
            del comps[: self._consumed]
            self._consumed = 0

    def stop(self) -> None:
        """Stop the engine loop, release the followers (a final stop tick),
        then shut the HTTP server down."""
        self._stop.set()
        self._engine_thread.join(timeout=60)
        if self._engine_thread.is_alive():
            raise RuntimeError("the engine thread did not stop; the followers are not released")
        _broadcast_blob({"reqs": [], "aborts": [], "stop": True}, self.engine.mesh.ctrl_group)
        self._httpd.shutdown()
        self._httpd.server_close()


def follow(engine: Engine) -> None:
    """The engine loop of a follower rank (rank != 0): block on each tick's
    broadcast, apply the identical submissions and aborts, step.  Returns
    when rank 0's server stops."""
    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 runs MultihostEngineServer")
    while True:
        tick = _broadcast_blob(None, engine.mesh.ctrl_group)
        if tick["stop"]:
            return
        for req in tick["reqs"]:
            try:
                engine.submit(req)
            except ValueError:
                pass  # rank 0 rejected it alike
        for uid in tick["aborts"]:
            engine.abort(uid)
        if _busy(engine):
            engine.step()
