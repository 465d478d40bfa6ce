"""Measured energy over a span: the GPU's and the host's counters.

  * GPU: NVML's total-energy counter (``nvmlDeviceGetTotalEnergyConsumption``,
    millijoules since the driver loaded), read through ``ctypes`` from the
    driver's own ``libnvidia-ml.so.1``; no package is needed.
  * Host: the RAPL powercap counters (package + DRAM domains summed, as
    ``aim_tpu/api.py::_read_energy_uj`` reads them).

Nothing is estimated: a counter that cannot be read gives None, and the
meter says why.  The reference's ``-DENERGY`` probe read its DIMM ranks'
counters (ref: host.c:62-67, 285-296); this is the H100 host's analogue.
"""

from __future__ import annotations

import ctypes
import glob

import torch


def read_host_energy_uj():
    """The RAPL powercap counters summed (microjoules), or None where the
    host exposes none (containers, most virtual machines)."""
    total, found = 0, False
    try:
        for p in glob.glob("/sys/class/powercap/*/energy_uj"):
            with open(p) as f:
                total += int(f.read().strip())
            found = True
    except (OSError, ValueError):
        return None
    return total if found else None


class _Nvml:
    """The device's handle in the driver's NVML library."""

    def __init__(self, device: torch.device):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self.lib = lib
        self.handle = ctypes.c_void_p()
        # by PCI bus id: under CUDA_VISIBLE_DEVICES a CUDA index need not
        # be the NVML index, and another card's joules are not this one's
        props = torch.cuda.get_device_properties(device)
        bus = getattr(props, "pci_bus_id", None)
        if bus is None:
            raise OSError("torch gives no PCI bus id to find the device by")
        bus_id = (f"{props.pci_domain_id:x}:{bus:x}:"
                  f"{props.pci_device_id:x}.0").encode()
        self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(
            ctypes.c_char_p(bus_id), ctypes.byref(self.handle)),
            "nvmlDeviceGetHandleByPciBusId_v2")

    @staticmethod
    def _check(rc, what):
        if rc != 0:
            raise OSError(f"{what} returned NVML error {rc}")

    def energy_mj(self) -> int:
        mj = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value


class Meter:
    """Reads both counters now; ``stop()`` returns (GPU J, host J) since
    then, each None where not measured (``gpu_missing`` says why for the
    GPU)."""

    def __init__(self, device):
        device = torch.device(device)
        self.gpu_missing = None
        self._nvml = None
        self._gpu0 = None
        if device.type != "cuda":
            self.gpu_missing = f"the run is on {device.type}, not a GPU"
        else:
            try:
                self._nvml = _Nvml(device)
                self._gpu0 = self._nvml.energy_mj()
            except (OSError, AttributeError) as e:
                self.gpu_missing = f"NVML unavailable: {e}"
                self._nvml = None
        self._host0 = read_host_energy_uj()

    def stop(self):
        gpu = host = None
        if self._nvml is not None:
            try:
                gpu = (self._nvml.energy_mj() - self._gpu0) / 1e3
            except OSError as e:
                self.gpu_missing = f"NVML read failed: {e}"
        if self._host0 is not None:
            h1 = read_host_energy_uj()
            if h1 is not None and h1 >= self._host0:  # counter wraparound
                host = (h1 - self._host0) / 1e6
        return gpu, host
