"""Run logging: screen + file tee with verbosity levels.

Copy of pyratbay_tpu/logger.py for a single process (the port runs on
one device and has no multi-process muting yet).
"""
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

    def __init__(self, logname=None, verb=2, width=70, append=False):
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
        verb >= 0; the raised ValueError carries it to the caller
        regardless.
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
