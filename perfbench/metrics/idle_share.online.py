"""The bulk cells' reader: 1 - (union of device-busy intervals) / wall
of the profiled slice."""

from pathlib import Path

from perfbench import plugins

read = plugins.load_module("metrics", "idle_share.bulk",
                           Path(__file__).resolve().parent.parent).read
