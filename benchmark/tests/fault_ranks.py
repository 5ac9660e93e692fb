"""A rank of a data-parallel run with the exchange between the ranks left
out: the trainer's all-reductions return each rank's own sums and the
replica check is skipped, so each rank steps on its own rows."""

from benchlib import launch


def exchange_left_out(*args):
    from anqs_quantum_chemistry_torch.experiments import vmc

    vmc.all_reduce = lambda x, mesh, op="sum": x
    vmc.VMC.check_replicas = lambda self: None
    return launch.run_rank(*args)
