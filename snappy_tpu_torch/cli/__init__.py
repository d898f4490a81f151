"""Command-line tools (``szip``-compatible)."""


def main(argv=None) -> int:
    """``szip``'s entry point (:func:`snappy_tpu_torch.cli.szip.main`),
    imported at the call so that ``python -m snappy_tpu_torch.cli.szip``
    runs a module that was not imported first."""
    from .szip import main as szip_main

    return szip_main(argv)
