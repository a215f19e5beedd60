"""Drivers: one general driver a kind of traffic, found by the ``driver``
key of a mix (``traffic/<mix>.json``).

A driver is built as ``Driver(cell, seed, device, variant)`` and offers
``setup()`` (inputs from the seed, warm-up of every shape the window
uses), ``window(seconds, trace)`` → `gwbench.record.Window`, ``release()``
(frees the program's state but for the answers kept for the check) and
``compare()`` → {number: reading} against the plain reference.
``variant`` is None for the program as configured; the control runs
(`gwbench.control`) pass the configuration's lower-precision path.
"""
from __future__ import annotations

import importlib


def load(kind: str):
    """The driver class of ``kind`` (``drivers/<kind>.py``)."""
    if not kind.isidentifier():
        raise ValueError(f"bad driver kind {kind!r}")
    return importlib.import_module(f"gwbench.drivers.{kind}").Driver
