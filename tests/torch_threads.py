"""One torch intra-op thread while a port test module runs (import
``one_torch_thread`` into the module). Its many small CPU ops (an LSTM
step a frame, a beam search's frame steps) lose most of their time to
intra-op threads spinning against the other test workers' pools."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
