"""The benchmark's own machinery: finding a cell's pieces (``spec``), the measured
window (``window``), reading the profiler's trace (``trace``), the table of peaks
(``peaks``), the comparison that decides ``correct`` (``checks``) and the import
check (``imports``)."""
