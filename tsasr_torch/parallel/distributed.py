"""Process-group helpers of a single-process run.

The JAX package's ``parallel/distributed.py`` runs a function on process
0, then waits at a barrier; the port runs one process, so every helper
here is that case's identity. DDP over ``torch.distributed`` is not
ported yet.
"""


def if_main_process():
    return True


def run_on_main(func, args=None, kwargs=None, post_func=None,
                post_args=None, post_kwargs=None):
    """Run ``func``; ``post_func`` is for the other processes, of which
    there are none."""
    func(*(args or ()), **(kwargs or {}))
