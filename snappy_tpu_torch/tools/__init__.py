"""Offline programs of the port that are not part of the library:
``fuzz_campaign``, the randomized differential campaign."""
