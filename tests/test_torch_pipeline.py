"""``data/pipeline.py::prefetch_to_device`` of the port, on the CPU: it reads
its iterator on a producer thread (as the JAX package's does), so host
decode overlaps the consumer's step; a consumer that stops early releases
the producer; a loader's error reaches the consumer; the batches come out
in order, numeric numpy leaves as tensors equal to them, other leaves as
they were."""

import threading

import numpy as np
import pytest
import torch

from nextgen_uia_tpu_torch.data.pipeline import prefetch_to_device

CPU = torch.device("cpu")


def test_prefetch_reads_the_iterator_on_another_thread():
    readers = []

    def source():
        for i in range(4):
            readers.append(threading.get_ident())
            yield {"i": np.array([i])}

    out = [b["i"].item() for b in prefetch_to_device(source(), device=CPU)]
    assert out == [0, 1, 2, 3]
    assert len(set(readers)) == 1 and readers[0] != threading.get_ident()


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    producer = []

    def endless():
        producer.append(threading.current_thread())
        i = 0
        while True:
            yield {"image": np.full((2, 4), i, np.uint8)}
            i += 1

    gen = prefetch_to_device(endless(), device=CPU, size=2)
    assert next(gen)["image"][0, 0].item() == 0
    next(gen)
    gen.close()  # mid-epoch: the producer sits on a full queue
    (thread,) = producer
    assert thread.name == "nextgen-uia-prefetch" and thread.daemon
    thread.join(timeout=2.0)
    assert not thread.is_alive(), "the prefetch producer outlived its consumer"


def test_prefetch_raises_the_loaders_error_in_the_consumer():
    def failing():
        yield {"x": np.zeros(3, np.float32)}
        raise OSError("cannot decode img_00001.png")

    gen = prefetch_to_device(failing(), device=CPU)
    assert torch.equal(next(gen)["x"], torch.zeros(3))
    with pytest.raises(OSError, match="img_00001.png"):
        next(gen)


def test_prefetch_keeps_the_order_and_contents():
    rng = np.random.default_rng(0)
    batches = [{"image": rng.integers(0, 256, (3, 5, 5), dtype=np.uint8),
                "feat": rng.standard_normal((3, 7)).astype(np.float32),
                "keep": rng.random(3) > 0.5, "names": [f"n{i}{j}" for j in range(3)],
                "n_real": i}
               for i in range(9)]
    out = list(prefetch_to_device(iter(batches), device=CPU, size=3))
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        assert set(got) == set(want)
        for k in ("image", "feat", "keep"):
            assert isinstance(got[k], torch.Tensor) and got[k].device == CPU
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got["names"] == want["names"] and got["n_real"] == want["n_real"]


@pytest.mark.gpu
def test_prefetch_stages_pinned_copies_on_the_card():
    """On a CUDA device (no index: the consumer's current one) the producer
    thread copies each leaf from pinned memory on a side stream; the
    consumer's stream waits on the copy, so the values are there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(1)
    batches = [{"image": rng.integers(0, 256, (16, 224, 224, 3), dtype=np.uint8),
                "feat": rng.standard_normal((16, 512)).astype(np.float32)} for _ in range(6)]
    out = []
    for b in prefetch_to_device(iter(batches), device=torch.device("cuda")):
        assert b["image"].device == torch.device("cuda", torch.cuda.current_device())
        out.append({k: (v.float() * 2).cpu() for k, v in b.items()})  # work on the stream
    for got, want in zip(out, batches):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].astype(np.float32) * 2)
