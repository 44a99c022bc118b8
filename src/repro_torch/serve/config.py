"""Uniform config-field coercion for the serving subsystems.

Every optional subsystem of the serving stack — result cache, capacity
control, tracing — is switched on the same way on ``ServeConfig`` /
``SchedulerConfig``::

    ServeConfig(cache=True, capacity={"window_s": 0.1}, trace=True)

    None / False   -> off (the stack stays bit-identical to the
                      subsystem-free behavior)
    True           -> on, with the subsystem's default knobs
    dict           -> on, dict unpacked as the config's kwargs
    config object  -> on, used as-is

:func:`coerce` is the one implementation of that rule;
:class:`Coercible` mixes it in as the ``coerce`` classmethod that
``CacheConfig``/``CapacityConfig``/``TraceConfig`` expose (and that
``ServeConfig.__post_init__``/``SchedulerConfig.__post_init__`` apply),
so no subsystem ever grows its own subtly-different spelling.

Port of ``repro.serve.config``.
"""
from __future__ import annotations

from typing import Optional, Type, TypeVar

C = TypeVar("C")
E = TypeVar("E")


def coerce_enum(enum_cls: Type[E], value: object, *, field: str) -> E:
    """Normalise one enum-valued config field (``BackpressurePolicy``,
    ``RoutingPolicy``): accepts the enum member or its string value, and
    raises the uniform error message listing the valid values — the enum
    sibling of :func:`coerce`, so every policy knob rejects typos the
    same way."""
    try:
        return enum_cls(value)
    except ValueError:
        valid = [m.value for m in enum_cls]
        raise ValueError(
            f"{field} must be one of {valid}, got {value!r}") from None


def coerce(cls: Type[C], value: object, *,
           field: Optional[str] = None) -> Optional[C]:
    """Normalise one config-field value to ``None`` (off) or a ``cls``
    instance: ``None``/``False`` -> off, ``True`` -> ``cls()`` defaults,
    ``dict`` -> ``cls(**value)``, ``cls`` instance -> itself. ``field``
    names the config field in the error message (defaults to the class
    name minus its ``Config`` suffix, lowercased)."""
    if value is None or value is False:
        return None
    if value is True:
        return cls()
    if isinstance(value, dict):
        return cls(**value)
    if isinstance(value, cls):
        return value
    name = field if field is not None \
        else cls.__name__.removesuffix("Config").lower()
    raise ValueError(
        f"{name} must be None/bool/dict/{cls.__name__}, got {value!r}")


class Coercible:
    """Mixin giving a config dataclass the shared ``coerce`` classmethod."""

    @classmethod
    def coerce(cls, value):
        """Normalise the config-field spellings: None/False -> off,
        True -> defaults, dict -> kwargs, instance -> itself."""
        return coerce(cls, value)
