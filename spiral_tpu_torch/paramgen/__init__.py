"""Parameter generation of the port (counterpart of spiral_tpu/paramgen):
the noise model (noise.py), the offline sweep and its artifact (sweep.py),
the LUT measured on the card (build_lut.py, h100_lut.json), the selection
ranked on it (search.py) and the empirical error analysis
(analyze_err.py)."""
