"""Device-memory and program accounting for serving: the port of the JAX
package's ``inference/resources.py``.

``ResourceLedger`` decomposes a deployment's device memory into its three
structural components, each derived from the code that owns it:

- **weights** — ``quantize.weight_bytes`` over the model's stored tensors
  (its param tree, plus the state tree of a layer model): every tensor
  at its STORED dtype, so an int4-quantized deployment reads well below
  its float twin.
- **kv_state** — the generation scheduler's committed decode state
  (``ContinuousBatcher.state_bytes()``): lane buffers, the paged pool and
  its scales, and the host-side cursors and spool bytes it pins.
- **executables** — the warmed programs (``aot_stats``, the scheduler's
  ``program_stats``) and the device bytes their CUDA graphs' memory pools
  hold (``InferenceModel.aot_memory_bytes``; None where no graph was
  captured, as on the CPU).

The ledger feeds the ``serving_hbm_bytes{component=}`` gauges in the
engine registry and the ``resources`` block of the health document.

Importable without touching a device.
"""

from __future__ import annotations

from typing import Dict, Optional


def _tree_bytes(tree) -> int:
    if not tree:
        return 0
    from analytics_zoo_tpu_torch.inference.quantize import weight_bytes
    return int(weight_bytes(tree))


def _state_tree(model):
    """The layer model's state tree (BatchNormalization statistics), or
    None for a module without one."""
    from analytics_zoo_tpu_torch.nn.module import Layer
    inner = getattr(model, "_model", None)
    if not isinstance(inner, Layer):
        return None
    from analytics_zoo_tpu_torch.utils.convert import export_state
    return export_state(inner)


class ResourceLedger:
    """One deployment's device-memory decomposition.  ``doc()`` is cheap
    enough for every /healthz scrape: the weights component is cached per
    model epoch (the stored tensors change only with a re-load or a
    quantization, which bump it), the lane and program reads are
    O(lanes + programs)."""

    COMPONENTS = ("weights", "kv_state", "executables")

    def __init__(self, model, batcher=None):
        self.model = model
        self.batcher = batcher
        self._weights_cache: Optional[tuple] = None   # (epoch, bytes)
        self._qbits_cache: Optional[tuple] = None     # (epoch, bits)

    def _epoch(self):
        return getattr(self.model, "_epoch", None)

    # -- components ----------------------------------------------------------
    def weights_bytes(self) -> int:
        epoch = self._epoch()
        if self._weights_cache is not None \
                and self._weights_cache[0] == epoch:
            return self._weights_cache[1]
        try:
            n = _tree_bytes(getattr(self.model, "_params", None)) \
                + _tree_bytes(_state_tree(self.model))
        except Exception:  # noqa: BLE001 — exotic models and leaves
            n = 0
        self._weights_cache = (epoch, n)
        return n

    def kv_state_bytes(self) -> int:
        if self.batcher is None:
            return 0
        try:
            return int(self.batcher.state_bytes())
        except Exception:  # noqa: BLE001 — mid-construction race
            return 0

    def kv_state_doc(self) -> Optional[Dict]:
        """The kv_state decomposition: ``{lanes, paged_pool, scales, aux,
        total}`` from the scheduler, or None without one."""
        fn = getattr(self.batcher, "state_bytes_doc", None)
        if not callable(fn):
            return None
        try:
            return dict(fn())
        except Exception:  # noqa: BLE001 — mid-construction race
            return None

    def executables(self) -> Dict:
        stats = {"count": 0, "code_bytes": None, "programs": {}}
        aot_stats = getattr(self.model, "aot_stats", None)
        if callable(aot_stats):
            try:
                s = aot_stats()
                stats["count"] = int(s.get("cached_programs", 0))
                stats["programs"] = dict(s.get("programs") or {})
            except Exception:  # noqa: BLE001
                pass
        mem = getattr(self.model, "aot_memory_bytes", None)
        if callable(mem):
            try:
                stats["code_bytes"] = mem()
            except Exception:  # noqa: BLE001
                stats["code_bytes"] = None
        if self.batcher is not None:
            # the scheduler's program set (prefill/insert/decode) rides the
            # same accounting, keyed by its own program names
            try:
                gs = self.batcher.program_stats()
                stats["count"] += int(gs.get("count", 0))
                stats["programs"].update(gs.get("programs") or {})
            except Exception:  # noqa: BLE001
                pass
        return stats

    # -- surfaces ------------------------------------------------------------
    def doc(self) -> Dict:
        """The health-doc ``resources`` block."""
        w = self.weights_bytes()
        kv = self.kv_state_bytes()
        exes = self.executables()
        code = exes.get("code_bytes")
        out = {
            "weights_bytes": w,
            "kv_state_bytes": kv,
            "executables": exes,
            "total_bytes": w + kv + (code or 0),
        }
        kvd = self.kv_state_doc()
        if kvd is not None:
            out["kv_state"] = kvd
        # cached per epoch like weights: quantized_bits walks the whole
        # param tree, and this runs on every /healthz scrape
        epoch = self._epoch()
        if self._qbits_cache is None or self._qbits_cache[0] != epoch:
            qbits = None
            try:
                from analytics_zoo_tpu_torch.inference.quantize import (
                    quantized_bits)
                qbits = quantized_bits(getattr(self.model, "_params",
                                               None) or {})
            except Exception:  # noqa: BLE001
                pass
            self._qbits_cache = (epoch, qbits)
        if self._qbits_cache[1] is not None:
            out["quantized_bits"] = self._qbits_cache[1]
        return out

    def hbm_bytes(self, component: str) -> float:
        """Gauge provider for ``serving_hbm_bytes{component=}``."""
        if component == "weights":
            return float(self.weights_bytes())
        if component == "kv_state":
            return float(self.kv_state_bytes())
        if component == "executables":
            return float(self.executables().get("code_bytes") or 0)
        return 0.0
