"""Foreign-model interop — the JAX package's ``interop/__init__.py``:
``keras_import`` (tf.keras models converted into the port's layers) is
ported; the bridges that run a foreign runtime (TFNet, TorchNet, ONNX)
are not, and the lazy names the JAX package exports for them raise
(ROADMAP queue 1, item 10).

Imports are lazy: a bridge pulls its host framework (tensorflow) only
when used.
"""

_BRIDGES = ("TorchNet", "TorchCriterion", "OnnxNet", "load_onnx", "TFNet")


def __getattr__(name):
    if name in _BRIDGES:
        raise NotImplementedError(
            f"interop.{name}: the foreign-runtime bridges are not ported "
            "(ROADMAP queue 1, item 10)")
    raise AttributeError(name)
