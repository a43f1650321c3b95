"""Append-only request journal: the serving crash-recovery record, the
port of ``flexflow_tpu/serving/journal.py`` (same records, same fold,
same tolerance), so a journal written by either package replays in the
other.

One JSONL file per server.  Every record is written at a fence the loop
already has: an admission after the prefill's readback, a token delta
after a decode superstep's readback, a completion when a request leaves
the loop.  Journaling adds no fence, and a crash loses at most one
superstep of tokens, which the resume regenerates: the journal's replay
re-admits the request with its validated tokens carried, and the
re-prefill over ``prompt ‖ carried`` continues it byte-identically
(greedy because decode follows the full-sequence forward, sampled
because each draw is keyed by (seed, request id, position)).

Records (every line carries ``ev``):

- ``sv_admit``  {id, plen, tok, resumed}: the prefill was read back;
  ``tok`` is the first generated token (absent after a non-finite
  prefill), ``resumed`` the carried-token count of a re-admission.
- ``sv_tokens`` {id, toks}: the tokens one slot appended in one decode
  superstep (under speculation the accepted prefix and the verify
  token only).
- ``sv_done``   {id, plen, n, error, ...metrics}: the request left the
  loop (completed, errored or rejected).
- ``sv_drain``  {in_flight, queued}: a drain on SIGTERM completed.

Replay folds the records into :class:`JournalState`: a request with an
``sv_done`` is completed (never re-run), one admitted and not done is
in flight (it resumes with its carried tokens), any other is still
queued.  A resumed server appends to the same file, so a second crash
replays the union.  Records of an unknown kind are skipped with one
warning.  The file is read by ``obs/reader.py::RunLog.load``, the
port's one JSONL reader: a torn last line (a crash mid-append) is
dropped and flagged, a garbled line inside the file is counted and
dropped, and nothing raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Iterable, List, Optional

EV_ADMIT = "sv_admit"
EV_TOKENS = "sv_tokens"
EV_DONE = "sv_done"
EV_DRAIN = "sv_drain"

#: Every record kind this revision writes; anything else in a replayed
#: journal is a later revision's record and is skipped with a warning.
KNOWN_KINDS = frozenset({EV_ADMIT, EV_TOKENS, EV_DONE, EV_DRAIN})


@dataclasses.dataclass
class JournalState:
    """What a journal says about a workload's progress."""

    #: id -> the finished record: {"tokens", "plen", "error", and any
    #: recorded metrics (latency_s, ...)}.
    completed: Dict[int, Dict[str, Any]]
    #: id -> validated generated tokens of admitted, unfinished requests
    #: (the carried prefix of the re-prefill resume).
    in_flight: Dict[int, List[int]]
    #: A drain marker closed the journal (the run exited cleanly with
    #: work remaining).
    drained: bool = False
    #: The last line was torn mid-append (a crash, tolerated).
    torn_tail: bool = False
    #: Garbled lines inside the file, dropped.
    malformed: int = 0
    #: kind -> records skipped because this revision does not know them.
    unknown_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.completed and not self.in_flight


def fold_journal_events(events: Iterable[Any]) -> JournalState:
    """Fold a journal's records (dicts carrying ``ev``, or objects with
    ``ev`` and ``data`` as the JAX package's reader gives) into a
    :class:`JournalState`.  Unknown kinds are counted in
    ``state.unknown_kinds`` and warned once for the whole stream."""
    state = JournalState(completed={}, in_flight={})
    acc: Dict[int, List[int]] = {}
    unknown: Dict[str, int] = {}
    for e in events:
        kind = e.ev if hasattr(e, "ev") else e.get("ev")
        if kind == EV_ADMIT:
            rid = int(e["id"])
            toks = acc.setdefault(rid, [])
            if e.get("tok") is not None:
                toks.append(int(e["tok"]))
        elif kind == EV_TOKENS:
            acc.setdefault(int(e["id"]), []).extend(
                int(t) for t in e.get("toks", ()))
        elif kind == EV_DONE:
            rid = int(e["id"])
            data = e.data if hasattr(e, "data") else e
            rec = {k: v for k, v in data.items()
                   if k not in ("ev", "id", "n", "ts", "seq")}
            rec["tokens"] = acc.pop(rid, [])
            rec.setdefault("error", None)
            rec.setdefault("plen", 0)
            state.completed[rid] = rec
        elif kind == EV_DRAIN:
            state.drained = True
        else:
            unknown[str(kind)] = unknown.get(str(kind), 0) + 1
    state.in_flight = {rid: toks for rid, toks in acc.items()
                       if rid not in state.completed}
    if unknown:
        state.unknown_kinds = dict(sorted(unknown.items()))
        warnings.warn(
            f"journal replay skipped {sum(unknown.values())} record(s) of "
            f"unknown kind(s) {sorted(unknown)}, written by a newer "
            f"revision? Known work replayed normally.", stacklevel=2)
    return state


class RequestJournal:
    """Append-only JSONL journal of one serving loop.  Each record is one
    line, flushed when written (the loop writes only at its fences, so
    the flush is paid once a superstep); :meth:`replay` reads it back
    through ``RunLog.load``."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = None

    # -- write side ---------------------------------------------------------

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()

    def admit(self, rid: int, prompt_len: int, tok0: Optional[int],
              resumed: int = 0) -> None:
        rec: Dict[str, Any] = {"ev": EV_ADMIT, "id": int(rid),
                               "plen": int(prompt_len),
                               "resumed": int(resumed)}
        if tok0 is not None:
            rec["tok"] = int(tok0)
        self._write(rec)

    def tokens(self, rid: int, toks: List[int]) -> None:
        if not toks:
            return
        self._write({"ev": EV_TOKENS, "id": int(rid),
                     "toks": [int(t) for t in toks]})

    def done(self, rid: int, prompt_len: int, n_tokens: int,
             error: Optional[str] = None, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"ev": EV_DONE, "id": int(rid),
                               "plen": int(prompt_len),
                               "n": int(n_tokens), "error": error}
        rec.update({k: v for k, v in metrics.items() if v is not None})
        self._write(rec)

    def drain(self, in_flight: int, queued: int) -> None:
        self._write({"ev": EV_DRAIN, "in_flight": int(in_flight),
                     "queued": int(queued)})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- read side ----------------------------------------------------------

    def replay(self) -> JournalState:
        """Fold the journal into a :class:`JournalState`.  A missing file
        is an empty (fresh) journal; a torn tail or a garbled line is
        tolerated; unknown kinds are skipped with one warning."""
        if not os.path.exists(self.path):
            return JournalState(completed={}, in_flight={})
        from flexflow_torch.obs.reader import RunLog

        log = RunLog.load(self.path)
        state = fold_journal_events(log.events)
        state.torn_tail = log.torn_tail
        state.malformed = log.malformed
        return state


class MemoryJournal(RequestJournal):
    """A :class:`RequestJournal` that keeps its records in a list: the
    same write API and the same fold, without a file."""

    def __init__(self):
        super().__init__(path="<memory>")
        self.records: List[Dict[str, Any]] = []

    def _write(self, rec: Dict[str, Any]) -> None:
        self.records.append(dict(rec))

    def close(self) -> None:
        pass

    def replay(self) -> JournalState:
        return fold_journal_events(self.records)
