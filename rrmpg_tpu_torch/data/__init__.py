"""Loader for the CAMELS toy data bundled with ``rrmpg_tpu``."""

from .camelsloader import CAMELSLoader
