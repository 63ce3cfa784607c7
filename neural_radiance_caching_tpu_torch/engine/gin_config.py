"""A small gin-compatible configuration engine (the port's own copy of
``engine/gin_config.py``).

The framework's public API is its gin config surface: the ``configs/*.gin``
scene files of `Class.field = value` bindings with includes, `@fn`
references and `%ENUM.VALUE` macros. This module implements the subset of
gin that those files use:

  * `include 'other.gin'` (resolved relative to the including file, with a
    search path fallback)
  * `Configurable.field = <python literal>` including tuples/dicts/lists
  * `@module.fn` / `@Class` configurable references (resolve at parse time to
    the registered function/class)
  * `%MACRO` / `%Enum.VALUE` constants
  * `\\` line continuations and `#` comments
  * multi-line literals (parentheses/brackets/braces spanning lines)

Bindings are applied at construction time: `configurable`-wrapped callables
merge the parsed bindings under their explicit kwargs (explicit wins, same
precedence as gin). A configurable class takes the bindings of its own name
only: a subclass that inherits a configurable ``__init__`` gets its own
wrapper, and the wrapper of a base class merges nothing when the object
under construction is of a subclass (the bindings a flax module dataclass
receives, one ``__init__`` per class).

Registrations and bindings are module-level state: tests clear the bindings
after each test (``clear_config``).
"""

from __future__ import annotations

import ast
import enum
import re
import threading
from typing import Any, Callable, Dict, Optional

_LOCK = threading.RLock()

# name -> callable (class or function)
_REGISTRY: Dict[str, Callable] = {}
# configurable name -> {param: value}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
# macro name (e.g. 'ModelType.MATERIAL') -> value
_CONSTANTS: Dict[str, Any] = {}


class GinError(ValueError):
    pass


def clear_config():
    """Drop all bindings (registrations and constants are kept)."""
    with _LOCK:
        _BINDINGS.clear()


def register(name: str, obj: Callable):
    with _LOCK:
        _REGISTRY[name] = obj
        short = name.split(".")[-1]
        # Also register the unqualified name if unambiguous.
        if short != name and short not in _REGISTRY:
            _REGISTRY[short] = obj
    return obj


def configurable(obj=None, *, name: Optional[str] = None):
    """Class/function decorator: make it bindable from gin files.

    For classes we wrap __init__ so gin bindings become default kwargs; for
    functions we wrap the call. The wrapped object keeps its identity
    (classes are returned as-is with a patched __init__, preserving
    dataclass/flax semantics).
    """

    def wrap(o):
        reg_name = name or o.__name__
        register(reg_name, o)
        if isinstance(o, type):
            orig_init = o.__init__

            def __init__(self, *args, **kwargs):  # noqa: N807
                if type(self) is o:
                    kwargs = {**get_bindings(reg_name), **kwargs}
                orig_init(self, *args, **kwargs)

            __init__.__wrapped_by_gin__ = True
            o.__init__ = __init__
            return o

        def fn_wrapper(*args, **kwargs):
            merged = dict(get_bindings(reg_name))
            merged.update(kwargs)
            return o(*args, **merged)

        fn_wrapper.__name__ = o.__name__
        fn_wrapper.__doc__ = o.__doc__
        fn_wrapper.__wrapped__ = o
        register(reg_name, fn_wrapper)
        return fn_wrapper

    return wrap(obj) if obj is not None else wrap


def external_configurable(fn, module: Optional[str] = None, name: Optional[str] = None):
    """Register an existing function so `@module.name` resolves to it."""
    n = name or fn.__name__
    full = f"{module}.{n}" if module else n
    register(full, fn)
    return fn


def constant(name: str, value):
    with _LOCK:
        _CONSTANTS[name] = value
    return value


def constants_from_enum(cls):
    """Register every member of an enum as `%EnumName.MEMBER`."""
    if not issubclass(cls, enum.Enum):
        raise TypeError(f"{cls} is not an Enum")
    for member in cls:
        constant(f"{cls.__name__}.{member.name}", member)
    register(cls.__name__, cls)
    return cls


def get_bindings(name: str) -> Dict[str, Any]:
    with _LOCK:
        return dict(_BINDINGS.get(name, {}))


def bind(configurable_name: str, param: str, value):
    with _LOCK:
        _BINDINGS.setdefault(configurable_name, {})[param] = value


_QUERY_SENTINEL = object()


def query_parameter(full_name: str, default=_QUERY_SENTINEL):
    """gin.query_parameter parity: 'Config.max_steps' -> bound value.

    Falls back to the registered callable's dataclass/field default when the
    parameter is not bound (the trainer queries defaults this way).
    """
    cname, param = full_name.rsplit(".", 1)
    bindings = get_bindings(cname)
    if param in bindings:
        return bindings[param]
    with _LOCK:
        target = _REGISTRY.get(cname)
    if target is not None:
        import dataclasses as _dc

        if isinstance(target, type) and _dc.is_dataclass(target):
            for f in _dc.fields(target):
                if f.name == param:
                    if f.default is not _dc.MISSING:
                        return f.default
                    if f.default_factory is not _dc.MISSING:  # type: ignore[misc]
                        return f.default_factory()  # type: ignore[misc]
        elif isinstance(target, type):
            if hasattr(target, param):
                return getattr(target, param)
    if default is not _QUERY_SENTINEL:
        return default
    raise GinError(f"No binding or default for {full_name}")


def operative_config_str() -> str:
    """Render current bindings as gin-ish text (for logging/checkpoints)."""
    lines = []
    with _LOCK:
        for cname in sorted(_BINDINGS):
            for p, v in sorted(_BINDINGS[cname].items()):
                lines.append(f"{cname}.{p} = {v!r}")
    return "\n".join(lines)


# --- Parsing ----------------------------------------------------------------

_REF_TOKEN = re.compile(r"@([A-Za-z_][\w\.]*)")
_MACRO_TOKEN = re.compile(r"%([A-Za-z_][\w\.]*)")


class _Ref:
    """Marker wrapper produced for @name references during literal eval."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _resolve_ref(name: str):
    with _LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
        short = name.split(".")[-1]
        if short in _REGISTRY:
            return _REGISTRY[short]
    raise GinError(f"Unknown configurable reference @{name}")


def _resolve_macro(name: str):
    with _LOCK:
        if name in _CONSTANTS:
            return _CONSTANTS[name]
    raise GinError(f"Unknown macro %{name}")


def parse_value(text: str):
    """Parse a gin literal: python literals plus @refs and %macros."""
    src = _REF_TOKEN.sub(lambda m: f'__ref__("{m.group(1)}")', text)
    src = _MACRO_TOKEN.sub(lambda m: f'__macro__("{m.group(1)}")', src)
    env = {
        "__ref__": _resolve_ref,
        "__macro__": _resolve_macro,
        "inf": float("inf"),
        "nan": float("nan"),
        "True": True,
        "False": False,
        "None": None,
        "__builtins__": {},
    }
    try:
        return eval(compile(ast.parse(src, mode="eval"), "<gin>", "eval"), env)  # noqa: S307
    except GinError:
        raise
    except Exception as e:
        raise GinError(f"Cannot parse gin value {text!r}: {e}") from e


def _logical_lines(text: str):
    """Yield logical gin lines: strip comments, join continuations/brackets."""
    buf = ""
    depth = 0
    for raw in text.splitlines():
        # Strip comments (naive: gin strings in these configs don't contain #).
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() and not buf:
            continue
        if line.endswith("\\"):
            buf += line[:-1] + " "
            continue
        buf += line
        depth = buf.count("(") - buf.count(")")
        depth += buf.count("[") - buf.count("]")
        depth += buf.count("{") - buf.count("}")
        if depth > 0:
            buf += " "
            continue
        if buf.strip():
            yield buf.strip()
        buf = ""
    if buf.strip():
        yield buf.strip()


def parse_config(text: str, *, search_paths=(), _seen=None):
    """Parse gin text, applying bindings to the global registry."""
    import os

    _seen = _seen if _seen is not None else set()
    for line in _logical_lines(text):
        if line.startswith("include"):
            m = re.match(r"include\s+['\"](.+?)['\"]", line)
            if not m:
                raise GinError(f"Malformed include: {line}")
            target = m.group(1)
            path = None
            for base in search_paths:
                cand = os.path.join(base, target)
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                raise GinError(f"Cannot find include {target!r} in {search_paths}")
            if os.path.abspath(path) in _seen:
                continue
            _seen.add(os.path.abspath(path))
            with open(path) as f:
                parse_config(
                    f.read(),
                    search_paths=(os.path.dirname(path),) + tuple(search_paths),
                    _seen=_seen,
                )
            continue

        m = re.match(r"([A-Za-z_][\w\.]*)\.([A-Za-z_]\w*)\s*=\s*(.+)$", line, re.S)
        if not m:
            raise GinError(f"Cannot parse gin line: {line!r}")
        cname, param, value_text = m.groups()
        bind(cname, param, parse_value(value_text))


def parse_config_file(path: str, extra_bindings=()):
    import os

    with open(path) as f:
        text = f.read()
    parse_config(
        text,
        search_paths=(os.path.dirname(os.path.abspath(path)),),
        _seen={os.path.abspath(path)},
    )
    for b in extra_bindings:
        parse_config(b, search_paths=(os.path.dirname(os.path.abspath(path)),))


def parse_config_files_and_bindings(config_files=(), bindings=(), skip_unknown=False):
    """gin-API-compatible entry point."""
    del skip_unknown
    for p in config_files:
        parse_config_file(p)
    for b in bindings or ():
        parse_config(b)
