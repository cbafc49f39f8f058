#!/usr/bin/env python3
"""The JAX package's CPU run of ``chip_smoke.py`` phase 16's detection
protocol: the reference its VOC07 mAP threshold (``SSD_MAP_MIN``) is
taken from.

The example's protocol (``examples/ssd_voc_eval.py --arch vgg16``): the
same fixture (``chip_smoke.ssd_fixture(0)``: 48 images of planted
rectangles of 3 classes at 300x300), model (``SSDVGG(class_num=4,
resolution=300)``), optimizer (Adam at ``SSD_LR``), batch
(``SSD_BATCH``) and epochs (``SSD_EPOCHS``) as the phase, on the JAX
package's ``SSDVGG``, ``multibox_loss`` and ``Estimator`` on the CPU in
f32; then ``detect`` on the training images above ``SSD_SCORE`` (the
example's threshold) and above ``SSD_EVAL_SCORE`` (the SSD paper's
evaluation threshold, which the phase's gate uses).  Prints each
epoch's mean loss and, at each threshold, VOC07 / VOC12 mAP with
``PascalVocEvaluator(num_classes=4)`` (the background counted, so the 3
planted classes are scored), and beside them the example's own
``num_classes=3``, which drops the last class.  ``--init`` seeds the JAX
weights (the port's are drawn by its own generator, so several inits
bound the spread); with ``--port-weights`` each run starts from the
port's weights drawn with that seed, the phase's own start.  A run takes
about 6-8 minutes of an 8-core CPU and ~8 GB of memory::

    JAX_PLATFORMS=cpu python3 ssd_reference.py --init 0 1 2
    JAX_PLATFORMS=cpu python3 ssd_reference.py --port-weights --init 0
"""

from __future__ import annotations

import argparse
import functools
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", type=int, nargs="+", default=[0],
                    help="seeds of the JAX weights, one run each")
    ap.add_argument("--port-weights", action="store_true",
                    help="start each run from the port's weights drawn "
                         "with the seed (SSDVGG.model.init_weights, as the "
                         "phase draws them) instead of JAX's")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from analytics_zoo_tpu.common import dtypes
    from analytics_zoo_tpu.common.context import get_context
    from analytics_zoo_tpu.estimator.estimator import Estimator
    from analytics_zoo_tpu.models.objectdetection import (
        SSDVGG, PascalVocEvaluator, multibox_loss)
    from analytics_zoo_tpu.nn.optimizers import Adam

    dtypes.set_policy(None)
    images, gts = cs.ssd_fixture(0)
    for init in args.init:
        get_context().set_seed(0)
        t0 = time.time()
        ssd = SSDVGG(class_num=cs.SSD_CLASSES, resolution=cs.SSD_RESOLUTION)
        if args.port_weights:
            import torch
            from analytics_zoo_tpu_torch.utils.convert import (
                export_params, export_state)
            port = cs.ssd_model(torch.device("cpu"))
            port.model.init_weights(init)
            as_np = functools.partial(jax.tree.map, lambda t: t.numpy())
            ssd.model.set_weights(as_np(export_params(port.model)),
                                  as_np(export_state(port.model)))
            del port
        else:
            ssd.model.init_weights(jax.random.PRNGKey(init))
        targets = ssd.encode_targets([g[0] for g in gts],
                                     [g[1] for g in gts])
        est = Estimator(ssd.model, optimizer=Adam(lr=cs.SSD_LR),
                        loss=functools.partial(multibox_loss,
                                               class_num=cs.SSD_CLASSES))
        losses = []
        est._listeners.append(lambda s, l: losses.append(float(l)))
        est.fit(images, targets, batch_size=cs.SSD_BATCH,
                epochs=cs.SSD_EPOCHS, verbose=False)
        ssd.model._params = est.params
        ssd.model._state = est.state
        t_fit = time.time() - t0
        per = len(losses) // cs.SSD_EPOCHS
        out = {"init": init, "port_weights": args.port_weights,
               "fit_s": round(t_fit, 1),
               "epoch_loss": [round(sum(losses[i:i + per]) / per, 4)
                              for i in range(0, len(losses), per)]}
        for score in (cs.SSD_SCORE, cs.SSD_EVAL_SCORE):
            dets = ssd.detect(images, score_threshold=score)
            out[f"detections@{score}"] = sum(len(d) for d in dets)
            for n in (cs.SSD_CLASSES, cs.SSD_CLASSES - 1):
                for tag, use07 in (("voc07", True), ("voc12", False)):
                    ev = PascalVocEvaluator(num_classes=n,
                                            use_07_metric=use07)
                    out[f"{tag}_map_n{n}@{score}"] = \
                        ev.evaluate(dets, gts)["mAP"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
