"""DAVIS evaluation of the PyTorch port: J&F metrics, the scorer, and the
glue that writes a results tree from a `Pipeline` and scores it; COCO mAP
(`coco.py`) and per-frame IoU with overlay dumps (`visualize.py`)."""
from slowfast_vos_tpu_torch.eval.glue import davis_evaluation, extract_masks
from slowfast_vos_tpu_torch.eval.metrics import boundary_f_measure, db_statistics, jaccard
from slowfast_vos_tpu_torch.eval.scorer import DavisScorer, summarize

__all__ = ["DavisScorer", "boundary_f_measure", "davis_evaluation", "db_statistics", "extract_masks", "jaccard", "summarize"]
