"""Host spans and program readings of one run, recorded from the
benchmark's side.

The program is not edited: :meth:`Recorder.wrap` replaces a method or
module function of the port for the length of a run with one that times
the call (``time.perf_counter``) and, in a traced run, opens a
``torch.profiler.record_function`` range ``perfbench.<name>`` around it, so
that the device trace can give each kernel the harness span that launched
it.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "perfbench."


class Recorder:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: Dict[str, List[float]] = defaultdict(list)  # seconds
        self._patches: List[tuple] = []

    @contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function(PREFIX + name)
              if self.annotate else nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, owner, attr: str, name: str,
             after: Optional[Callable] = None) -> None:
        """Time every call of ``owner.attr`` as span ``name``; ``after(args,
        kwargs, result)`` runs outside the span."""
        orig = getattr(owner, attr)
        rec = self

        @functools.wraps(orig)
        def wrapped(*a, **kw):
            with rec.span(name):
                out = orig(*a, **kw)
            if after is not None:
                after(a, kw, out)
            return out

        setattr(owner, attr, wrapped)
        self._patches.append((owner, attr, orig))

    def restore(self) -> None:
        while self._patches:
            owner, attr, orig = self._patches.pop()
            setattr(owner, attr, orig)
