from serenade_tpu_torch.utils.h5 import (  # noqa: F401
    find_files,
    read_hdf5,
    write_hdf5,
    HDF5ScpLoader,
    NpyScpLoader,
)
from serenade_tpu_torch.utils.masking import (  # noqa: F401
    length_mask,
    make_pad_mask,
    make_non_pad_mask,
)
from serenade_tpu_torch.utils.scalers import (  # noqa: F401
    StandardScaler,
    MinMaxScaler,
)
