"""Evaluation judges (counterpart of activesplat_tpu/eval): exploration
coverage by action replay (replay.py), map quality and novel-view synthesis
of a saved map (replay.py, nvs.py), the metrics they report (metrics.py,
lpips.py) and the batch runner over scene sets (batch.py)."""
