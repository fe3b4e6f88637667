"""Run logging: screen + file tee with verbosity levels.

Copy of pyratbay_tpu/logger.py.  The reference mutes rank != 0
processes entirely (mc3.utils.Log with verb=-1, tools/parser.py there);
here the rank is PBT_PROCID, else that of an initialized
torch.distributed group (parallel/distributed.py): only rank 0 prints
or writes a log file, and errors still raise on every rank.
"""
import os
import sys
import textwrap
import time

__all__ = ['Log']


class Log:
    """Screen + file message tee.

    Verbosity gates (matching the reference's convention):
      verb <= -1: mute everything (including warnings);
      verb ==  0: errors + warnings only;
      verb >=  1: head messages;
      verb >=  2: regular messages;
      verb >=  3: debug messages.
    The log file (when given) receives everything regardless of verb.
    """

    # True when the caller chose the screen alone (driver.run's
    # with_log=False, or a log file that could not be opened):
    screen_only = False

    def __init__(self, logname=None, verb=2, width=70, append=False,
                 rank=None):
        if rank is None:
            rank = _process_index()
        self.rank = rank
        if rank != 0:
            # Only rank 0 speaks or writes:
            verb = -1
            logname = None
        self.logname = logname
        self.verb = verb
        self.width = width
        self.warnings = []
        self.sep = width * ':'
        self.file = None
        if logname is not None:
            self.file = open(logname, 'a' if append else 'w')
        self._t0 = time.time()

    # -- plumbing ------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self.file is not None and not self.file.closed:
            self.file.close()

    def _emit(self, message, min_verb, indent=0, file=None):
        text = textwrap.indent(str(message), ' ' * indent)
        if self.verb >= min_verb:
            # Resolve the stream at call time so runtime redirection
            # (tests, tee wrappers) is honored:
            print(text, file=sys.stdout if file is None else file)
        if self.file is not None and not self.file.closed:
            self.file.write(text + '\n')
            self.file.flush()

    # -- public API (reference mc3.utils.Log surface) -------------------
    def write(self, message):
        """File-only write."""
        if self.file is not None and not self.file.closed:
            self.file.write(str(message) + '\n')

    def head(self, message, indent=0):
        self._emit(message, 1, indent)

    def msg(self, message, indent=0):
        self._emit(message, 2, indent)

    def debug(self, message, indent=0):
        self._emit(message, 3, indent)

    def warning(self, message):
        self.warnings.append(str(message))
        self._emit(
            f'{self.sep}\n  Warning:\n{textwrap.indent(str(message), "  ")}'
            f'\n{self.sep}',
            0, file=sys.stderr,
        )

    def error(self, message):
        """Log and raise: fatal configuration/runtime errors.

        The message goes to the log file always, and to stderr only when
        verb >= 0 (so muted rank != 0 processes stay silent); the raised
        ValueError carries it to the caller regardless.
        """
        text = f'Error: {message}'
        if self.file is not None and not self.file.closed:
            self.file.write(text + '\n')
            self.file.flush()
        if self.verb >= 0:
            print(text, file=sys.stderr)
        self.close()
        raise ValueError(message)

    def summary(self, timestamps=None):
        """Write a run summary: collected warnings + phase timings."""
        if timestamps:
            self.msg('Timestamps (s):')
            for key, val in timestamps.items():
                self.msg(f'  {key:16s} {val:10.4f}')
        if self.warnings:
            self.msg(f'Collected {len(self.warnings)} warnings.')
        self.msg(f'Total runtime: {time.time() - self._t0:.2f} s')


def _process_index():
    """PBT_PROCID, else the rank of an initialized process group, else
    0."""
    if os.environ.get('PBT_PROCID'):
        return int(os.environ['PBT_PROCID'])
    from .parallel.distributed import process_index
    return process_index()
