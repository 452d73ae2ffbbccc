import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from portbench.tests.tiny import make_root

    return make_root(tmp_path_factory.mktemp("portbench"))
