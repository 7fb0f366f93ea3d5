"""Ray, sampling, compaction and compositing math of the port."""
