"""The benchmark's reference: the upstream analyzer's answers
(``pixeru/bpm_analysis``, run on the CPU with its own numpy/scipy engine
over the synthetic recordings the traffic generators make), frozen under
``answers/<pool>.npz`` (``freeze.py``), and the comparison that decides
``correct`` (``compare.py``).  Imports nothing of the port."""
