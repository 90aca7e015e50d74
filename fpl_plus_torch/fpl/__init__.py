"""FPL+ filtering and data tools: pixel and image weights, manifests and
dataset preprocessing, on the host (``python -m fpl_plus_torch.fpl``)."""
from fpl_plus_torch.fpl.weights import (compute_pixel_weights,
                                      write_image_weight_csv)
from fpl_plus_torch.fpl.manifests import (create_image_label_csv,
                                          random_split_csv)

__all__ = ['compute_pixel_weights', 'write_image_weight_csv',
           'create_image_label_csv', 'random_split_csv']
