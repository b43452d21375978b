"""``train_lora`` on the last five LoRA family cases against the JAX
package's (``tests/torch_lora_cases.py`` ``check_train_lora`` says
what is held and to what tolerance; the other five are in
``tests/test_torch_lora_families_train_a.py``: two files, so that two
test workers share the JAX compiles)."""
import pytest
import torch

from torch_lora_cases import TARGETS, check_train_lora

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(TARGETS)[5:])
def test_train_lora_matches_jax(name, caplog, monkeypatch):
    check_train_lora(name, caplog, monkeypatch)
