"""The one binding of the port's hand-written kernels
(``utils/cuda_build.CudaKernel``): a launch of the QP's or of the plant's
kernel checks its tensors once against the kernel's declared contract and
refuses, before any build or launch and with one ValueError that names the
tensor, what was expected and what was got, every input the C entry does
not take: a shape, a batch, a dtype, a layout or a device other than the
first input's; and any tensor off CUDA. The QP's CPU entry
(``solve_fd_qp``) holds its inputs to the same contract."""

from __future__ import annotations

import pytest
import torch

from chip_smoke import plant_states
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
from quadruped_locomotion_tpu_torch.rollout import articulated as art
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.utils.logging import counters


def _qp_inputs() -> dict:
    gen = torch.Generator().manual_seed(0)
    return {"G": torch.eye(12).expand(2, 12, 12).contiguous(),
            "g": torch.randn(2, 12, generator=gen),
            "D": torch.randn(2, 20, 12, generator=gen),
            "d": -torch.ones(2, 20)}


def _plant_inputs() -> dict:
    model, sim, tau, support, gz, _ = plant_states("rest", 3, "cpu")
    return art.kernel_inputs(model, sim, tau, support, gz)


# kernel -> (its binding, its inputs by name, its scalars, its batch)
KERNELS = {
    "qp": (fk.KERNEL, _qp_inputs, (15,), 2),
    "plant": (art.KERNEL, _plant_inputs,
              (art.plant_consts(cl.CONTROL_DT, art.SUBSTEPS, None), 0), 3),
}

# kernel -> case -> (the input spoiled, how, what the error says)
SPOILED = {
    "qp": {
        "shape": ("D", lambda t: t[:, :19], r"D: expected shape \(2, 20, 12\)"),
        "batch": ("d", lambda t: t[1:], r"d: expected shape \(2, 20\)"),
        "dtype": ("G", torch.Tensor.double, "G: expected torch.float32"),
        "contiguity": ("G", lambda t: t.mT, "G: expected a contiguous"),
        "device": ("g", lambda t: t.to("meta"), "g: expected a tensor on cpu"),
        "cpu": (None, None, "needs CUDA"),
    },
    "plant": {
        "non_contiguous": ("q", lambda t: t.mT.contiguous().mT,
                           "q: expected a contiguous"),
        "wrong_shape": ("anchors", lambda t: t[:, :3],
                        r"anchors: expected shape \(3, 4, 3\)"),
        "wrong_batch": ("ground_height", lambda t: t[1:],
                        r"ground_height: expected shape \(3, 4\)"),
        "float64": ("tau", torch.Tensor.double, "tau: expected torch.float32"),
        "flags_not_bool": ("support", lambda t: t.to(torch.uint8),
                           "support: expected torch.bool"),
        "model_size": ("model", lambda t: t[:-1],
                       r"model: expected shape \(120,\)"),
        "cpu": (None, None, "CUDA tensor"),
    },
}


@pytest.mark.parametrize("kernel,case", [(k, c) for k, cases in SPOILED.items()
                                         for c in cases])
def test_a_launch_refuses_what_the_kernel_does_not_take(kernel, case):
    binding, inputs, scalars, batch = KERNELS[kernel]
    ins = inputs()
    assert binding.check(*ins.values()) == batch
    name, spoil, says = SPOILED[kernel][case]
    if name is not None:
        ins[name] = spoil(ins[name])
    before = (counters[f"{kernel}.kernel_launches"],
              counters[f"{kernel}.kernel_instances"])
    with pytest.raises(ValueError, match=says):
        binding(*ins.values(), *scalars)
    if kernel == "qp" and name is not None:
        with pytest.raises(ValueError, match=says):
            fk.solve_fd_qp(*ins.values())
    assert (counters[f"{kernel}.kernel_launches"],
            counters[f"{kernel}.kernel_instances"]) == before
