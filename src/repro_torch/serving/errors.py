"""Typed errors for family/feature gating in the serving layer.

The engine's fast paths (bucketed prefill, chunked prefill, paged KV)
are family-aware rather than family-excluded, but a few combinations
stay genuinely unsupported (e.g. chunked prefill for MoE, whose
expert capacity depends on the token count integrated so far, and
bucketed prefill for SSM/hybrid, whose recurrent state integrates
every input position).  Those guards raise ``UnsupportedFamilyError``
— a ``ValueError`` subclass so pre-existing ``except ValueError``
call sites keep working — naming the family, the feature, and the
families that DO support it, instead of a free-text message a caller
cannot dispatch on.

This module sits below both ``serving.engine`` and ``serving.ops``
(and is imported lazily from ``kernels.ops``, which layers beneath
the serving package) so every guard site can share one type without
import cycles.
"""

from __future__ import annotations

from typing import Sequence


class UnsupportedFamilyError(ValueError):
    """A serving fast path was requested for a model family that
    cannot support it.

    Attributes: ``family`` (the offending config family), ``feature``
    (the fast path that was requested), ``supported`` (the families
    the feature is available for).  Subclasses ``ValueError`` so the
    pre-typed guard contract (``pytest.raises(ValueError)``) is
    unchanged.
    """

    def __init__(self, family: str, feature: str,
                 supported: Sequence[str] = ()):
        self.family = str(family)
        self.feature = str(feature)
        self.supported = tuple(supported)
        msg = f"family {self.family!r} does not support {self.feature}"
        if self.supported:
            msg += f" (supported families: {', '.join(self.supported)})"
        super().__init__(msg)
