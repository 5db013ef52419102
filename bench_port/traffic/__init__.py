"""Traffic generators: ``<kind>.py`` exposes ``make(params, seed, workdir)``,
which builds one run's inputs from the seed and a workload file's
``traffic`` parameters."""
