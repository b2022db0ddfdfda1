from repro_torch.data.partition import (Partition, partition_by_class,
                                        partition_iid, partition_unequal)
from repro_torch.data.synthetic import (SyntheticImageDataset, add_noise,
                                        make_extended_mnist, make_not_mnist,
                                        one_hot)
