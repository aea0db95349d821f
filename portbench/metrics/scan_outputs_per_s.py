"""scan_outputs_per_s: outputs of the window's batches, each tried with
every viewing key of the cell and its secrets and ``ok`` mask on the host,
over the window's seconds (first batch's start to last batch's end).  Host
clock.  Read in the cells that the metric's ``workloads`` list names,
whatever their path."""


def read(run):
    return run.work_done / run.window_s
