"""Pass-through hooks around the program's entry points, for one run.

Each patched attribute gets one installed wrapper, whatever number of hooks
it carries; the last hook added runs outermost.  A hook is
`hook(call, *args, **kwargs)`: it calls `call(*args, **kwargs)` to go on to
the next hook and at last the program's own function, and returns what the
caller gets.  `set` replaces a module's constant.  `remove` puts every
attribute back.
"""

from __future__ import annotations

import functools
import importlib


class Patches:
    def __init__(self):
        self._hooks: dict[tuple[int, str], list] = {}
        self._undo: list = []

    def hook(self, module: str, owner: str | None, attr: str, hook) -> bool:
        """Adds `hook` around `module.owner.attr` (`module.attr` where the
        owner is None); False, and nothing added, where that is missing."""
        obj = importlib.import_module(module)
        if owner is not None:
            obj = getattr(obj, owner, None)
        if obj is None or not callable(vars(obj).get(attr)):
            return False
        key = (id(obj), attr)
        if key not in self._hooks:
            orig = vars(obj)[attr]
            hooks = self._hooks[key] = []

            def run(i, args, kwargs):
                if i < 0:
                    return orig(*args, **kwargs)
                return hooks[i](lambda *a, **k: run(i - 1, a, k),
                                *args, **kwargs)

            @functools.wraps(orig)
            def installed(*args, **kwargs):
                return run(len(hooks) - 1, args, kwargs)

            setattr(obj, attr, installed)
            self._undo.append((obj, attr, orig))
        self._hooks[key].append(hook)
        return True

    def set(self, module: str, attr: str, value) -> None:
        """Sets a module's constant until `remove`."""
        obj = importlib.import_module(module)
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def remove(self) -> None:
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()
        self._hooks.clear()
