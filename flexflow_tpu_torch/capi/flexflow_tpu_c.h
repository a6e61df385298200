/* flexflow_tpu_c.h — flat C API for the flexflow_tpu framework.
 *
 * Mirrors the reference's C surface (python/flexflow_c.h:49-125: opaque
 * handles for FFConfig/FFModel/Tensor plus per-op adders and training
 * verbs), so a non-Python host — or a cffi binding — can drive the full
 * graph-build / compile / train loop.  The implementation
 * (flexflow_tpu_c.cpp) embeds CPython and dispatches to the Python core:
 * on TPU the runtime under every call is the same fused XLA program, so the
 * C layer is a thin veneer by design rather than a 2k-LoC re-implementation.
 *
 * Build:  g++ -O2 -shared -fPIC flexflow_tpu_c.cpp \
 *             $(python3-config --includes) $(python3-config --ldflags --embed) \
 *             -o libflexflow_tpu_c.so
 */

#ifndef FLEXFLOW_TPU_C_H
#define FLEXFLOW_TPU_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct flexflow_config_st* flexflow_config_t;
typedef struct flexflow_model_st* flexflow_model_t;
typedef struct flexflow_tensor_st* flexflow_tensor_t;
typedef struct flexflow_optimizer_st* flexflow_optimizer_handle_t;

typedef enum { FF_DT_FLOAT = 0, FF_DT_INT32 = 1, FF_DT_INT64 = 2,
               FF_DT_DOUBLE = 3 } flexflow_datatype_t;
typedef enum { FF_AC_NONE = 0, FF_AC_RELU = 1, FF_AC_SIGMOID = 2,
               FF_AC_TANH = 3, FF_AC_GELU = 4 } flexflow_activation_t;
typedef enum { FF_OPT_SGD = 0, FF_OPT_ADAM = 1 } flexflow_optimizer_t;
typedef enum { FF_LOSS_SPARSE_CCE = 0, FF_LOSS_CCE = 1,
               FF_LOSS_MSE = 2 } flexflow_loss_t;

/* ---- runtime ---- */
/* Initialize the embedded runtime; safe to call more than once.
 * Returns 0 on success. */
int flexflow_init(void);
void flexflow_finalize(void);
/* Last error message ("" when none). */
const char* flexflow_last_error(void);

/* ---- config (reference flexflow_c.h: flexflow_config_*) ---- */
flexflow_config_t flexflow_config_create(int argc, char** argv);
void flexflow_config_destroy(flexflow_config_t);
int flexflow_config_get_batch_size(flexflow_config_t);
int flexflow_config_get_epochs(flexflow_config_t);
int flexflow_config_get_workers_per_node(flexflow_config_t);
/* NetConfig (reference flexflow_c.h:520-528, :1055): dataset path parsed
 * from the -d/--dataset flag.  Returns a pointer owned by the config —
 * valid until flexflow_config_destroy. */
const char* flexflow_config_get_dataset_path(flexflow_config_t);

/* ---- model + tensors ---- */
flexflow_model_t flexflow_model_create(flexflow_config_t);
void flexflow_model_destroy(flexflow_model_t);
flexflow_tensor_t flexflow_model_create_tensor(
    flexflow_model_t, int ndims, const int64_t* dims,
    flexflow_datatype_t dtype, const char* name);
void flexflow_tensor_destroy(flexflow_tensor_t);
int flexflow_tensor_get_ndims(flexflow_tensor_t);
int64_t flexflow_tensor_get_dim(flexflow_tensor_t, int idx);

/* ---- op adders (reference flexflow_c.h per-op surface from :133) ---- */
flexflow_tensor_t flexflow_model_conv2d(
    flexflow_model_t, flexflow_tensor_t input, int out_channels,
    int kernel_h, int kernel_w, int stride_h, int stride_w,
    int padding_h, int padding_w, flexflow_activation_t activation,
    int use_bias, const char* name);
flexflow_tensor_t flexflow_model_pool2d(
    flexflow_model_t, flexflow_tensor_t input, int kernel_h, int kernel_w,
    int stride_h, int stride_w, int padding_h, int padding_w,
    int is_max_pool, const char* name);
flexflow_tensor_t flexflow_model_dense(
    flexflow_model_t, flexflow_tensor_t input, int out_dim,
    flexflow_activation_t activation, int use_bias, const char* name);
/* aggr: "sum"/"avg" (bag mode) or "none" (sequence mode: (n,s) ids ->
 * (n,s,d)); NULL means "sum". */
flexflow_tensor_t flexflow_model_embedding(
    flexflow_model_t, flexflow_tensor_t input, int num_entries, int out_dim,
    const char* aggr, const char* name);
flexflow_tensor_t flexflow_model_flat(flexflow_model_t, flexflow_tensor_t,
                                      const char* name);
flexflow_tensor_t flexflow_model_softmax(flexflow_model_t, flexflow_tensor_t,
                                         const char* name);
flexflow_tensor_t flexflow_model_concat(flexflow_model_t, int n,
                                        flexflow_tensor_t* inputs, int axis,
                                        const char* name);
flexflow_tensor_t flexflow_model_add(flexflow_model_t, flexflow_tensor_t,
                                     flexflow_tensor_t, const char* name);
flexflow_tensor_t flexflow_model_dropout(flexflow_model_t, flexflow_tensor_t,
                                         float rate, const char* name);
flexflow_tensor_t flexflow_model_batch_norm(flexflow_model_t,
                                            flexflow_tensor_t, int relu,
                                            const char* name);
flexflow_tensor_t flexflow_model_mse_loss(flexflow_model_t, flexflow_tensor_t,
                                          const char* reduction,
                                          const char* name);
/* Element-wise families (reference per-op adders exp/relu/sigmoid/...;
 * op: "relu","gelu","sigmoid","tanh","elu","exp","identity"). */
flexflow_tensor_t flexflow_model_unary(flexflow_model_t, const char* op,
                                       flexflow_tensor_t, const char* name);
/* op: "add","sub","mul","div". */
flexflow_tensor_t flexflow_model_binary(flexflow_model_t, const char* op,
                                        flexflow_tensor_t, flexflow_tensor_t,
                                        const char* name);
flexflow_tensor_t flexflow_model_layer_norm(flexflow_model_t,
                                            flexflow_tensor_t,
                                            const char* name);
flexflow_tensor_t flexflow_model_rms_norm(flexflow_model_t, flexflow_tensor_t,
                                          const char* name);
/* Equal split into n_outputs parts along axis; fills outputs[0..n).
 * Returns 0 on success. */
int flexflow_model_split(flexflow_model_t, flexflow_tensor_t, int n_outputs,
                         int axis, flexflow_tensor_t* outputs,
                         const char* name);
flexflow_tensor_t flexflow_model_reshape(flexflow_model_t, flexflow_tensor_t,
                                         int ndims, const int64_t* dims,
                                         const char* name);
flexflow_tensor_t flexflow_model_transpose(flexflow_model_t,
                                           flexflow_tensor_t, int ndims,
                                           const int* perm, const char* name);
/* Self-attention when key/value are NULL (transformer workload). */
flexflow_tensor_t flexflow_model_multihead_attention(
    flexflow_model_t, flexflow_tensor_t query,
    flexflow_tensor_t key /* or NULL */, flexflow_tensor_t value /* or NULL */,
    int embed_dim, int num_heads, float dropout, int use_bias, int causal,
    const char* name);
flexflow_tensor_t flexflow_model_position_embedding(flexflow_model_t,
                                                    flexflow_tensor_t,
                                                    const char* name);
/* LSTM (NMT workload): returns the (n,s,H) sequence; when non-NULL,
 * h_out / c_out receive the final hidden/cell state tensors.  Pass
 * h_init/c_init (both or neither) to seed the state (encoder->decoder). */
flexflow_tensor_t flexflow_model_lstm(flexflow_model_t, flexflow_tensor_t,
                                      int hidden_size,
                                      flexflow_tensor_t h_init /* or NULL */,
                                      flexflow_tensor_t c_init /* or NULL */,
                                      flexflow_tensor_t* h_out,
                                      flexflow_tensor_t* c_out,
                                      const char* name);
/* Mixture-of-Experts FFN over the 'e' mesh axis. */
flexflow_tensor_t flexflow_model_moe(flexflow_model_t, flexflow_tensor_t,
                                     int num_experts, int d_ff, int k,
                                     float capacity_factor, const char* name);

/* ---- optimizer handles (reference flexflow_c.h sgd/adam create) ---- */
flexflow_optimizer_handle_t flexflow_sgd_optimizer_create(
    double lr, double momentum, int nesterov, double weight_decay);
flexflow_optimizer_handle_t flexflow_adam_optimizer_create(
    double alpha, double beta1, double beta2, double weight_decay,
    double epsilon);
void flexflow_optimizer_destroy(flexflow_optimizer_handle_t);

/* ---- compile + training verbs (reference flexflow_c.h:86-125) ---- */
int flexflow_model_compile(flexflow_model_t, flexflow_optimizer_t opt,
                           double lr, flexflow_loss_t loss,
                           flexflow_tensor_t final_tensor /* or NULL */);
/* Compile with a configured optimizer handle (full hyperparameters). */
int flexflow_model_compile_opt(flexflow_model_t,
                               flexflow_optimizer_handle_t opt,
                               flexflow_loss_t loss,
                               flexflow_tensor_t final_tensor /* or NULL */);
int flexflow_model_init_layers(flexflow_model_t, int seed);
/* One fused training step on host buffers (row-major, batch-major).
 * inputs[i] points at the i-th graph input; label is the label buffer.
 * Returns the loss, or NaN on error. */
double flexflow_model_train_batch(flexflow_model_t, int n_inputs,
                                  const void** inputs, const void* label);
/* Legacy verb API: set_batch then forward/zero_gradients/backward/update. */
int flexflow_model_set_batch(flexflow_model_t, int n_inputs,
                             const void** inputs, const void* label);
int flexflow_model_forward(flexflow_model_t);
int flexflow_model_zero_gradients(flexflow_model_t);
double flexflow_model_backward(flexflow_model_t);
int flexflow_model_update(flexflow_model_t);

/* ---- weights I/O (reference Parameter::get/set_weights) ---- */
/* Copies the named parameter into buf (float32); returns element count,
 * or -1 on error. Pass buf=NULL to query the size. */
int64_t flexflow_model_get_weights(flexflow_model_t, const char* name,
                                   float* buf, int64_t capacity);
int flexflow_model_set_weights(flexflow_model_t, const char* name,
                               const float* buf, int64_t count);

/* ---- strategy files (reference -import/-export, strategy.cc:87-163) ---- */
/* Stage a strategy .pb to be applied by the next compile call. */
int flexflow_model_import_strategies(flexflow_model_t, const char* path);
/* Dump the compiled per-op strategies to a strategy .pb. */
int flexflow_model_export_strategies(flexflow_model_t, const char* path);

/* ---- checkpoint (params + optimizer state + step; .npz) ---- */
int flexflow_model_save_checkpoint(flexflow_model_t, const char* path);
int flexflow_model_load_checkpoint(flexflow_model_t, const char* path);

#ifdef __cplusplus
}
#endif

#endif /* FLEXFLOW_TPU_C_H */
