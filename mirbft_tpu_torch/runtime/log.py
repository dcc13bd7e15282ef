"""Leveled key-value logging (reference: logger.go:13-62)."""

from __future__ import annotations

import enum
import sys


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3


class Logger:
    """Minimal interface: level methods taking a message + kv pairs."""

    def log(self, level: LogLevel, text: str, **kv) -> None:
        raise NotImplementedError

    def debug(self, text: str, **kv) -> None:
        self.log(LogLevel.DEBUG, text, **kv)

    def info(self, text: str, **kv) -> None:
        self.log(LogLevel.INFO, text, **kv)

    def warn(self, text: str, **kv) -> None:
        self.log(LogLevel.WARN, text, **kv)

    def error(self, text: str, **kv) -> None:
        self.log(LogLevel.ERROR, text, **kv)


class ConsoleLogger(Logger):
    def __init__(self, min_level: LogLevel = LogLevel.WARN, stream=None):
        self.min_level = min_level
        self.stream = stream if stream is not None else sys.stderr

    def log(self, level: LogLevel, text: str, **kv) -> None:
        if level < self.min_level:
            return
        pairs = " ".join(f"{k}={v!r}" for k, v in kv.items())
        print(f"[{level.name}] {text}" + (f" {pairs}" if pairs else ""),
              file=self.stream)
