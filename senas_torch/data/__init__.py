from senas_torch.data.base import (
    DATASETS,
    DataLoader,
    DatasetSpec,
    PrefetchLoader,
    get_dataset,
    get_dataset_spec,
)
