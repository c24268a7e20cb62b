"""Live progress meter.

Equivalent of the reference's ``progress_meter::ProgressMeter``
(reference: src/common/progress.hpp:14-86): a background thread repaints
one stderr line every 500 ms with percent complete, bp/s throughput,
elapsed and estimated remaining time; ``finish`` paints 100% and joins.
Counterpart of ``mashmap_tpu/progress.py`` (plain Python, the same
paints).
"""

from __future__ import annotations

import sys
import threading
import time


def _fmt_dhms(seconds: float) -> str:
    seconds = max(0, int(seconds))
    d, rem = divmod(seconds, 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    return f"{d:02d}:{h:02d}:{m:02d}:{s:02d}"


class ProgressMeter:
    def __init__(self, total: int, banner: str,
                 stream=None, interval: float = 0.5):
        # total <= 0 => unsized meter: paints count + rate only (used
        # when stderr is not a tty and no .fai exists, so sizing would
        # cost a full pass over the query files)
        self.sized = int(total) > 0
        self.total = max(int(total), 1)
        self.banner = banner
        self.stream = stream if stream is not None else sys.stderr
        # Non-tty streams (piped/captured logs) get line-oriented,
        # change-driven paints at >=10s spacing instead of a 500 ms
        # carriage-return repaint loop that floods the log.
        try:
            self._tty = bool(self.stream.isatty())
        except Exception:
            self._tty = False
        self.interval = interval
        self._min_gap = 0.0 if self._tty else interval * 20.0
        self._last_paint = 0.0
        self._last_count = -1
        self._count = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._t0 = time.time()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def increment(self, n: int) -> None:
        with self._lock:
            self._count += int(n)

    def _paint(self, force: bool = False) -> None:
        elapsed = time.time() - self._t0
        with self._lock:
            count = self._count
        if not force:
            if elapsed - self._last_paint < self._min_gap:
                return
            if not self._tty and count == self._last_count:
                return          # unchanged: nothing new to log
        self._last_paint = elapsed
        self._last_count = count
        rate = count / max(elapsed, 1e-9)
        lead, tail = ("\r", "") if self._tty else ("", "\n")
        if self.sized:
            frac = min(count / self.total, 1.0)
            remain = (self.total - count) / rate if rate > 0 else 0.0
            self.stream.write(
                f"{lead}{self.banner} {100.0 * frac:2.2f}% @ {rate:.2e} "
                f"bp/s elapsed: {_fmt_dhms(elapsed)} "
                f"remain: {_fmt_dhms(remain)}{tail}")
        else:
            self.stream.write(
                f"{lead}{self.banner} {count} bp @ {rate:.2e} bp/s "
                f"elapsed: {_fmt_dhms(elapsed)}{tail}")
        self.stream.flush()

    def _loop(self) -> None:
        while not self._done.wait(self.interval):
            self._paint()

    def finish(self) -> None:
        self._done.set()
        self._thread.join()
        if self.sized:
            with self._lock:
                self._count = self.total
        self._paint(force=True)
        if self._tty:
            self.stream.write("\n")
        self.stream.flush()
