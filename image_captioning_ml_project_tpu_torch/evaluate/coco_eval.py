"""Full-COCO evaluation: generate -> ``results.json`` -> metrics.

A copy of ``image_captioning_ml_project_tpu.evaluate.coco_eval``: caption
every image of an eval-mode dataset (the final short batch padded, so each
image is captioned exactly once), write ``results.json`` in the COCO
results schema, then score, through pycocotools when it is installed and
an annotation file is given, else with the references the loader
collected (:func:`.metrics.calculate_metrics`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.coco import iterate_batches
from ..parallel.mesh import batch_rows, gather_rows_host
from .metrics import calculate_metrics


def evaluate_model_on_coco(
    decode_batch_fn: Callable[[Dict], object],
    dataset,
    tokenizer,
    batch_size: int = 32,
    results_file: str = "results.json",
    annotation_file: Optional[str] = None,
    num_workers: int = 0,
    mesh=None,
) -> Dict[str, float]:
    """``decode_batch_fn(batch) -> tokens [B, L]`` (a host array or a
    tensor on any device) over a host batch of ``dataset``, which must be
    an eval-mode dataset (grouped references). Returns the metric dict and
    writes ``results_file`` (where one is named). Under ``mesh`` the
    batches hold this rank's rows of the data axis
    (``iterate_batches(rows=)``), and their tokens, validity and ids are
    gathered from every rank on the host, in the whole batch's order."""
    logger = logging.getLogger(__name__)
    results: List[Dict] = []
    generated, references, image_ids = [], [], []
    rows = None if mesh is None else batch_rows(batch_size, mesh)

    for batch in iterate_batches(dataset, batch_size, shuffle=False,
                                 drop_last=False, pad_last=True,
                                 num_workers=num_workers, rows=rows):
        tokens = decode_batch_fn(batch)
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        tokens, valid, ids = (gather_rows_host(np.asarray(a), mesh)
                              for a in (tokens, batch["batch_valid"],
                                        batch["image_id"]))
        for i in range(len(tokens)):
            if not valid[i]:
                continue
            caption = tokenizer.decode(tokens[i], skip_special_tokens=True)
            image_id = int(ids[i])
            results.append({"image_id": image_id, "caption": caption})
            generated.append(caption)
            references.append(batch["captions"][i])
            image_ids.append(image_id)

    if results_file:
        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "w") as f:
            json.dump(results, f)
        logger.info("Wrote %d captions to %s", len(results), results_file)

    # pycocotools when available (it reads the results from disk); any
    # failure there (the import, an image-id mismatch) keeps the
    # loader-collected references gathered above
    if annotation_file is not None and results_file:
        try:
            from pycocotools.coco import COCO

            coco = COCO(annotation_file)
            coco_res = coco.loadRes(results_file)
            gts = {iid: [a["caption"] for a in coco.imgToAnns[iid]]
                   for iid in coco_res.imgToAnns}
            generated = [coco_res.imgToAnns[iid][0]["caption"] for iid in gts]
            references = list(gts.values())
            image_ids = list(gts.keys())
        except ImportError:
            logger.info("pycocotools unavailable; scoring with loader refs")
        except Exception as e:  # loadRes asserts on id mismatches
            logger.warning("pycocotools scoring failed (%s); "
                           "scoring with loader refs", e)

    metrics = calculate_metrics(generated, references, image_ids)
    for k, v in metrics.items():
        logger.info("%s: %.4f", k, v)
    return metrics
