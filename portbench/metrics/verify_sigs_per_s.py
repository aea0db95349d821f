"""verify_sigs_per_s: signatures of the window's batches whose batch result
and ``ok`` mask reached the host, over the window's seconds (first batch's
start to last batch's end).  Host clock.  Read in the cells that the
metric's ``workloads`` list names, whatever their path."""


def read(run):
    return run.work_done / run.window_s
