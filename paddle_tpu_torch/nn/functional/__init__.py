"""paddle_tpu_torch.nn.functional — the functional namespace (F.*) of
the eager API: port of paddle_tpu/nn/functional/, every public name of
it, and the in-place twins of the activations that `ops.INPLACE` names
(`relu_`, `elu_`, `sigmoid_`, ...: `ops.attach_inplace`)."""
from .activation import (relu, relu6, gelu, silu, swish, elu,  # noqa: F401
                         selu, celu, leaky_relu, prelu, rrelu, hardshrink,
                         softshrink, tanhshrink, hardtanh, hardsigmoid,
                         hardswish, mish, softplus, softsign, log_sigmoid,
                         tanh, sigmoid, softmax, log_softmax, gumbel_softmax,
                         glu, maxout, thresholded_relu)
from .common import (linear, dropout, dropout2d, dropout3d,  # noqa: F401
                     alpha_dropout, embedding, normalize, cosine_similarity,
                     interpolate, upsample, pixel_shuffle, pixel_unshuffle,
                     channel_shuffle, unfold, fold, label_smooth,
                     pairwise_distance, zeropad2d, bilinear, sequence_mask,
                     temporal_shift, affine_grid, grid_sample, gather_tree)
from .norm import (layer_norm, rms_norm, batch_norm,  # noqa: F401
                   group_norm, instance_norm, local_response_norm,
                   spectral_norm)
from .loss import (cross_entropy, softmax_with_cross_entropy,  # noqa: F401
                   mse_loss, l1_loss, smooth_l1_loss, nll_loss,
                   binary_cross_entropy, binary_cross_entropy_with_logits,
                   kl_div, margin_ranking_loss, hinge_embedding_loss,
                   cosine_embedding_loss, triplet_margin_loss,
                   sigmoid_focal_loss, square_error_cost, ctc_loss,
                   poisson_nll_loss, gaussian_nll_loss, dice_loss, log_loss,
                   npair_loss, soft_margin_loss,
                   multi_label_soft_margin_loss, multi_margin_loss,
                   huber_loss, hsigmoid_loss,
                   triplet_margin_with_distance_loss, margin_cross_entropy,
                   ctc_greedy_decoder, adaptive_log_softmax_with_loss,
                   rnnt_loss)
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        flash_attention, flash_attn_unpadded)
from .conv import (conv1d, conv2d, conv3d, conv1d_transpose,  # noqa: F401
                   conv2d_transpose, conv3d_transpose, max_pool1d,
                   max_pool2d, max_pool3d, avg_pool1d, avg_pool2d,
                   avg_pool3d, adaptive_avg_pool1d, adaptive_avg_pool2d,
                   adaptive_avg_pool3d, adaptive_max_pool1d,
                   adaptive_max_pool2d, adaptive_max_pool3d, max_unpool1d,
                   max_unpool2d, max_unpool3d, lp_pool1d, lp_pool2d,
                   fractional_max_pool2d, fractional_max_pool3d)
# F.pad and F.one_hot are the ops (paddle_tpu/nn/functional/__init__.py:12)
from ...ops.manipulation import pad  # noqa: F401
from ...ops.creation import one_hot  # noqa: F401

from ...ops import attach_inplace as _attach_inplace  # noqa: E402

INPLACE_OPS = _attach_inplace(globals())
