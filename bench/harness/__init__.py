"""The benchmark's own machinery: the manifest and the files it names,
the traffic generator, the device checks, the spans and the reduction of
a profiler trace to per-layer numbers, and the table of peaks.

Nothing here imports the system under test at module level; the entries
under ``bench/entries/`` drive ``repro_torch`` through its public entry
points, and the references under ``bench/reference/`` import nothing of
it.
"""
