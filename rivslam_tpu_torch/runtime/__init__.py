"""Native (C++) runtime: mmap'd dataset container + prefetching loader (a
copy of ``rivslam_tpu/runtime``). ``native.get_lib`` builds the library with
g++ on first use, into the gitignored ``rivslam_tpu_torch/_build/``.
"""
