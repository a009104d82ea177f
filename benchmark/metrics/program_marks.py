"""The program's own spans (`gator_tpu_torch.profiling`), placed on a
traced run's timeline, for the readers of the metrics that read them.

The program records (name, start ns, end ns) on `time.time_ns()`; the
trace's times are microseconds from a base that a reader is not handed.
The program's k-th `serve` span opens a few microseconds after the
benchmark's k-th `serve_call` span, inside it. So the marks are placed
with offset = min over k of (program start - benchmark start): each is
placed at most its call's lag early, and none late. A program without the
recorder, no marks, or counts that differ give None."""
from typing import List, Optional, Sequence, Tuple

from benchmark.core.trace import Interval, Trace

Mark = Tuple[str, int, int]                  # (name, start ns, end ns)


def program_marks() -> Optional[List[Mark]]:
    """Every mark the program's recorder holds; None where the program
    has no recorder."""
    try:
        from gator_tpu_torch import profiling
        return profiling.marks()
    except (ImportError, AttributeError):
        return None


def placed(tr: Trace, marks: Optional[Sequence[Mark]],
           anchor: str = "serve", outer: str = "serve_call"
           ) -> Optional[List[Interval]]:
    """Every mark as (start us, end us, name) on `tr`'s timeline, the k-th
    `anchor` mark paired with the k-th benchmark span `outer`; None when
    there are no anchor marks or their count is not the spans'."""
    if not marks:
        return None
    starts = sorted(a for name, a, _ in marks if name == anchor)
    calls = sorted(a for a, _, name in tr.spans if name == outer)
    if not starts or len(starts) != len(calls):
        return None
    # in whole ns: wall-clock ns do not fit a float's 53 bits
    offset = min(a - round(c * 1e3) for a, c in zip(starts, calls))
    return sorted(((a - offset) / 1e3, (b - offset) / 1e3, name)
                  for name, a, b in marks)
