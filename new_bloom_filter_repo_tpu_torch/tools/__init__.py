"""The repository's tools on the port: the counterparts of the root
scripts that drive the JAX package (``bench.py``, ``benchmark_stages.py``,
``benchmark_compression.py``, ``download_y4m_videos.py``), one module
each under the script's own name, with its function names and flags.
Run them as modules::

    python -m new_bloom_filter_repo_tpu_torch.tools.bench
    python -m new_bloom_filter_repo_tpu_torch.tools.benchmark_stages
    python -m new_bloom_filter_repo_tpu_torch.tools.benchmark_compression --synthetic
    python -m new_bloom_filter_repo_tpu_torch.tools.download_y4m_videos --synthetic

Each runs on the current CUDA card unless given ``--device cpu``, and
raises ``RuntimeError`` without a card and without that flag.
"""
