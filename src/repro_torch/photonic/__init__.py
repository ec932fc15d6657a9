from repro_torch.photonic.devices import DEVICES, DeviceParams
from repro_torch.photonic.accelerator import SonicAccelerator, SonicHWConfig
from repro_torch.photonic.mapper import LayerWork, cnn_workload, lm_workload
from repro_torch.photonic.baselines import BASELINES, evaluate_all
