"""Two-tier flag system: CLI flags with env-var-seeded defaults.

A copy of ``distributed_tensorflow_tpu/utils/flags.py`` (pure host code;
the port imports nothing of the JAX package): ``DEFINE_*`` and a lazily
parsed ``FLAGS`` singleton, as the reference's ``tf.app.flags`` seeded
from ``os.environ``.  ``TASK_INDEX`` is parsed to an int before it becomes
a default (the reference passed the raw string, so no worker ever became
chief), and unknown arguments are ignored rather than fatal.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "DEFINE_string", "DEFINE_integer", "DEFINE_float", "DEFINE_bool",
    "FLAGS", "env_default",
]


def _parse_bool(text: str) -> bool:
    lowered = str(text).strip().lower()
    if lowered in ("1", "true", "t", "yes", "y"):
        return True
    if lowered in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean flag value {text!r}")


class Flag:
    def __init__(self, name: str, default: Any, help_text: str,
                 parser: Callable[[str], Any]):
        self.name = name
        self.default = default
        self.help = help_text
        self.parser = parser
        self.value = default
        self.present = False  # set True when seen on the command line


class FlagValues:
    """Registry + lazily-parsed value store (the ``FLAGS`` singleton)."""

    def __init__(self) -> None:
        self._flags: Dict[str, Flag] = {}
        self._parsed = False

    # -- registration -----------------------------------------------------
    def define(self, name: str, default: Any, help_text: str,
               parser: Callable[[str], Any]) -> None:
        if name in self._flags:
            # Re-definition with identical default is tolerated so that
            # modules can be re-imported (e.g. under pytest).
            self._flags[name].default = default
            if not self._flags[name].present:
                self._flags[name].value = default
            return
        self._flags[name] = Flag(name, default, help_text, parser)
        self._parsed = False

    # -- parsing ----------------------------------------------------------
    def parse(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse ``--name value`` / ``--name=value`` / ``--[no]boolflag``.

        Returns the list of arguments that were not recognised as flags.
        """
        if argv is None:
            argv = sys.argv[1:]
        remaining: List[str] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            consumed = False
            if arg.startswith("--"):
                body = arg[2:]
                if "=" in body:
                    key, _, raw = body.partition("=")
                    flag = self._flags.get(key)
                    if flag is not None:
                        flag.value = flag.parser(raw)
                        flag.present = True
                        consumed = True
                else:
                    flag = self._flags.get(body)
                    if flag is not None:
                        if flag.parser is _parse_bool:
                            flag.value = True
                            flag.present = True
                            consumed = True
                        else:
                            # A valued flag must be followed by its value —
                            # another --flag or end-of-argv means the value
                            # was forgotten; fail loudly rather than train
                            # with a silently unchanged default.
                            if (i + 1 >= len(argv) or
                                    argv[i + 1].startswith("--")):
                                raise ValueError(
                                    f"flag --{body} requires a value")
                            flag.value = flag.parser(argv[i + 1])
                            flag.present = True
                            i += 1
                            consumed = True
                    elif body.startswith("no") and body[2:] in self._flags:
                        flag = self._flags[body[2:]]
                        if flag.parser is _parse_bool:
                            flag.value = False
                            flag.present = True
                            consumed = True
            if not consumed:
                remaining.append(arg)
            i += 1
        self._parsed = True
        return remaining

    # -- access -----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        flags = self.__dict__.get("_flags", {})
        if name not in flags:
            raise AttributeError(f"flag --{name} is not defined")
        if not self.__dict__.get("_parsed", False):
            self.parse()
        return flags[name].value

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if name in self._flags:
            self._flags[name].value = value
            self._flags[name].present = True
        else:
            object.__setattr__(self, name, value)

    def reset(self) -> None:
        """Restore every flag to its default (test helper)."""
        for flag in self._flags.values():
            flag.value = flag.default
            flag.present = False
        self._parsed = False


FLAGS = FlagValues()


def DEFINE_string(name: str, default: Optional[str], help_text: str = "") -> None:
    FLAGS.define(name, default, help_text, str)


def DEFINE_integer(name: str, default: Optional[int], help_text: str = "") -> None:
    FLAGS.define(name, None if default is None else int(default), help_text, int)


def DEFINE_float(name: str, default: Optional[float], help_text: str = "") -> None:
    FLAGS.define(name, None if default is None else float(default), help_text, float)


def DEFINE_bool(name: str, default: Optional[bool], help_text: str = "") -> None:
    FLAGS.define(name, None if default is None else _parse_bool(str(default)),
                 help_text, _parse_bool)


def env_default(var: str, default: Any, cast: Callable[[str], Any] = str) -> Any:
    """Read an env var with a typed fallback.

    The reference wraps its env reads in a bare ``try/except`` that silently
    falls back to single-machine mode (reference example.py:59-68).  We keep
    the fallback semantics but only catch the actual failure modes (missing
    var, bad cast).
    """
    raw = os.environ.get(var)
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default
