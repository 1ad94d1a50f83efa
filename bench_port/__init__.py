"""The benchmark of viterbidecodercpp_torch on an H100 (see run.py)."""
