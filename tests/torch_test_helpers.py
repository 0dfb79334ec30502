"""What the port's test files share: the one-thread fixture and a stand-in
for one rank of a mesh.

A test file imports ``one_torch_thread`` to run its tests on one torch
thread (an autouse module fixture works where it is imported)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a file's small models: the suite runs six
    workers on the machine's cores, and every worker's full thread pool
    would spin against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The parts of a ``DeviceMesh`` that the port reads without a
    collective (sizes, this rank's indices), for one rank of a (data,
    model) mesh in a process with no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, rank):
        self.shape = (data, model)
        self.rank = rank

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return (self.rank // self.shape[1] if name == "data"
                else self.rank % self.shape[1])

    def get_group(self, name):
        return None
