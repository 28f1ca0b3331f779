"""Progress lines on standard error, each with the seconds since the
process started: where a run stopped is the last line it wrote."""

import sys
import time


def say(job, msg: str) -> None:
    print(f"portbench: {msg} ({time.time() - job.t_start:.1f} s)",
          file=sys.stderr, flush=True)
