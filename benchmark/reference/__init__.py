"""The plain reference that decides a run's ``correct``.

It reads the archives, restored trees and answers the timed path produced
and holds them against the generated tree. It imports nothing of
zpaqfranz_tpu_torch or of the JAX package: ``archive.py`` parses the jidac
format itself, and ``codec.py`` decodes blocks with ``zpaqd.c``, a decoder
written for it from the ZPAQ level-2 specification.
"""
