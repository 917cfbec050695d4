"""PyTorch + CUDA port of the AdaptCL reproduction (``repro``), for one H100."""
