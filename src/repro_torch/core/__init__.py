"""The paper's collectives, ported: copies of the reference's numpy machine
model (``topology``) and schedule generators (``schedule``), the process
groups that stand in for the mesh's named axes (``groups``), and the
collective families on ``torch.distributed`` (``collectives``).

Nothing is imported here: ``collectives`` needs ``torch.distributed`` and the
kernels, and the schedule copy needs neither, so each is imported by name.
"""
