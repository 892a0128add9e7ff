"""General drivers of the traffic mixes: ``traffic/<mix>.json`` names
one of these modules under ``driver``."""
