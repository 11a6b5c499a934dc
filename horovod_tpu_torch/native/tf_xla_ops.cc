// TF custom-op bridge of the PyTorch port: the engine's collectives as
// REGISTERED ops with XLA kernels (counterpart: horovod_tpu/native/
// tf_xla_ops.cc, copied; reference: horovod/tensorflow/mpi_ops.cc +
// xla_mpi_ops.cc — SURVEY.md §2.1 "TF binding" / "TF XLA binding").
//
// Two kernels per op:
//   * a CPU OpKernel (eager and non-jit tf.function graphs), and
//   * an XlaOpKernel lowering to a typed-FFI CustomCall, so the ops
//     survive tf.function(jit_compile=True) — the capability upstream
//     kept alive through XLA CustomCall registration.
//
// The ops (HorovodTorchCollective, HorovodTorchGroupedAllreduce) and the
// FFI targets (hvd_torch_collective_ffi, hvd_torch_grouped_ffi) carry
// names of their own, so this library and the JAX package's can load in
// one process: TF refuses a second registration of an op name.
//
// Both kernels funnel into one trampoline:
// horovod_tpu_torch.tensorflow._xla_bridge._dispatch, called under
// PyGILState_Ensure with zero-copy memoryviews of the input/output
// buffers.  The engine's Handle.synchronize() waits on a
// threading.Event, which releases the GIL — the background engine
// thread keeps running, so the blocking custom call cannot deadlock.
//
// The tensor-name attr must be pre-sanitized by the Python caller (it
// is embedded in the FFI backend_config dictionary).

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"
#include "tensorflow/compiler/tf2xla/xla_op_kernel.h"
#include "tensorflow/compiler/tf2xla/xla_op_registry.h"
#include "xla/hlo/builder/xla_builder.h"
#include "xla/shape_util.h"
#include "xla/ffi/api/ffi.h"

// Forward declaration instead of xla/ffi/ffi_api.h (that internal
// header pulls MLIR headers the pip wheel does not ship); the symbol
// itself is exported by the loaded TF/XLA libraries.
namespace xla {
namespace ffi {
const XLA_FFI_Api* GetXlaFfiApi();
}  // namespace ffi
}  // namespace xla

using namespace tensorflow;
namespace ffi = xla::ffi;

namespace {

// ---------------------------------------------------------------------
// dispatch trampoline (shared by the CPU kernels and the FFI handler)
// ---------------------------------------------------------------------

struct BufferRef {
  const void* data;
  std::vector<int64_t> dims;
};

struct MutBufferRef {
  void* data;
  std::vector<int64_t> dims;
};

int64_t NumElements(const std::vector<int64_t>& dims) {
  int64_t n = 1;
  for (int64_t d : dims) n *= d;
  return n;
}

PyObject* DimsTuple(const std::vector<int64_t>& dims) {
  PyObject* t = PyTuple_New(static_cast<Py_ssize_t>(dims.size()));
  for (size_t i = 0; i < dims.size(); ++i) {
    PyTuple_SET_ITEM(t, static_cast<Py_ssize_t>(i),
                     PyLong_FromLongLong(dims[i]));
  }
  return t;
}

// itemsize for the dtype strings _dispatch understands
int64_t ItemSize(const std::string& dtype) {
  if (dtype == "float64" || dtype == "int64") return 8;
  if (dtype == "bfloat16" || dtype == "float16") return 2;
  return 4;  // float32 / int32
}

std::string FetchPyError() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python dispatch failed";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

// Calls horovod_tpu_torch.tensorflow._xla_bridge._dispatch(kind, name, rop,
// root, pre, post, psid, dtype, ins, in_dims, outs, out_dims).
// psid = registered process-set id, -1 for the global set.  Returns ""
// on success, the error message otherwise.
std::string CallDispatch(const std::string& kind, const std::string& name,
                         const std::string& rop, int64_t root, double pre,
                         double post, int64_t psid,
                         const std::string& dtype,
                         const std::vector<BufferRef>& ins,
                         const std::vector<MutBufferRef>& outs) {
  PyGILState_STATE gil = PyGILState_Ensure();
  std::string err;
  PyObject* mod = PyImport_ImportModule(
      "horovod_tpu_torch.tensorflow._xla_bridge");
  PyObject* fn = nullptr;
  PyObject* args = nullptr;
  PyObject* res = nullptr;
  if (mod == nullptr) {
    err = FetchPyError();
  } else {
    fn = PyObject_GetAttrString(mod, "_dispatch");
    if (fn == nullptr) err = FetchPyError();
  }
  if (err.empty()) {
    const int64_t isz = ItemSize(dtype);
    PyObject* in_views = PyList_New(static_cast<Py_ssize_t>(ins.size()));
    PyObject* in_dims = PyList_New(static_cast<Py_ssize_t>(ins.size()));
    for (size_t i = 0; i < ins.size(); ++i) {
      PyList_SET_ITEM(
          in_views, static_cast<Py_ssize_t>(i),
          PyMemoryView_FromMemory(
              const_cast<char*>(static_cast<const char*>(ins[i].data)),
              NumElements(ins[i].dims) * isz, PyBUF_READ));
      PyList_SET_ITEM(in_dims, static_cast<Py_ssize_t>(i),
                      DimsTuple(ins[i].dims));
    }
    PyObject* out_views = PyList_New(static_cast<Py_ssize_t>(outs.size()));
    PyObject* out_dims = PyList_New(static_cast<Py_ssize_t>(outs.size()));
    for (size_t i = 0; i < outs.size(); ++i) {
      PyList_SET_ITEM(out_views, static_cast<Py_ssize_t>(i),
                      PyMemoryView_FromMemory(
                          static_cast<char*>(outs[i].data),
                          NumElements(outs[i].dims) * isz, PyBUF_WRITE));
      PyList_SET_ITEM(out_dims, static_cast<Py_ssize_t>(i),
                      DimsTuple(outs[i].dims));
    }
    args = Py_BuildValue("(sssLddLsOOOO)", kind.c_str(), name.c_str(),
                         rop.c_str(), static_cast<long long>(root), pre,
                         post, static_cast<long long>(psid), dtype.c_str(),
                         in_views, in_dims, out_views, out_dims);
    Py_DECREF(in_views);
    Py_DECREF(in_dims);
    Py_DECREF(out_views);
    Py_DECREF(out_dims);
    if (args == nullptr) {
      err = FetchPyError();
    } else {
      res = PyObject_CallObject(fn, args);
      if (res == nullptr) err = FetchPyError();
    }
  }
  Py_XDECREF(res);
  Py_XDECREF(args);
  Py_XDECREF(fn);
  Py_XDECREF(mod);
  PyGILState_Release(gil);
  return err;
}

std::string DtypeName(DataType dt) {
  switch (dt) {
    case DT_FLOAT: return "float32";
    case DT_DOUBLE: return "float64";
    case DT_INT32: return "int32";
    case DT_INT64: return "int64";
    case DT_BFLOAT16: return "bfloat16";
    case DT_HALF: return "float16";
    default: return "unsupported";
  }
}

std::vector<int64_t> ShapeDims(const TensorShape& s) {
  std::vector<int64_t> dims;
  dims.reserve(s.dims());
  for (int i = 0; i < s.dims(); ++i) dims.push_back(s.dim_size(i));
  return dims;
}

// Output shape per collective kind (n = worker count for the kinds
// whose dim 0 changes; validated Python-side before graph build).
TensorShape OutShape(const std::string& kind, const TensorShape& in,
                     int64_t n) {
  TensorShape out = in;
  if (kind == "allgather" && out.dims() > 0) {
    out.set_dim(0, out.dim_size(0) * n);
  } else if (kind == "reducescatter" && out.dims() > 0) {
    out.set_dim(0, out.dim_size(0) / n);
  }
  return out;
}

// ---------------------------------------------------------------------
// CPU kernels (eager + non-jit graphs)
// ---------------------------------------------------------------------

class HvdCollectiveCpuOp : public OpKernel {
 public:
  explicit HvdCollectiveCpuOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("kind", &kind_));
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &rop_));
    OP_REQUIRES_OK(c, c->GetAttr("root_rank", &root_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale", &pre_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale", &post_));
    OP_REQUIRES_OK(c, c->GetAttr("nproc", &nproc_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &psid_));
  }

  void Compute(OpKernelContext* c) override {
    const Tensor& in = c->input(0);
    const std::string dtype = DtypeName(in.dtype());
    OP_REQUIRES(c, dtype != "unsupported",
                errors::InvalidArgument("unsupported dtype"));
    Tensor* out = nullptr;
    OP_REQUIRES_OK(c, c->allocate_output(
        0, OutShape(kind_, in.shape(), nproc_), &out));
    std::vector<BufferRef> ins{{in.tensor_data().data(),
                                ShapeDims(in.shape())}};
    std::vector<MutBufferRef> outs{
        {const_cast<char*>(out->tensor_data().data()),
         ShapeDims(out->shape())}};
    const std::string err = CallDispatch(kind_, name_, rop_, root_, pre_,
                                         post_, psid_, dtype, ins, outs);
    OP_REQUIRES(c, err.empty(), errors::Internal(err));
  }

 private:
  std::string kind_, name_, rop_;
  int64_t root_, nproc_, psid_;
  float pre_, post_;
};

class HvdGroupedCpuOp : public OpKernel {
 public:
  explicit HvdGroupedCpuOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &rop_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale", &pre_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale", &post_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &psid_));
  }

  void Compute(OpKernelContext* c) override {
    const int n = c->num_inputs();
    std::vector<BufferRef> ins;
    std::vector<MutBufferRef> outs;
    std::string dtype;
    for (int i = 0; i < n; ++i) {
      const Tensor& in = c->input(i);
      const std::string dt = DtypeName(in.dtype());
      OP_REQUIRES(c, dt != "unsupported",
                  errors::InvalidArgument("unsupported dtype"));
      OP_REQUIRES(c, dtype.empty() || dt == dtype,
                  errors::InvalidArgument(
                      "grouped allreduce requires one dtype per call"));
      dtype = dt;
      Tensor* out = nullptr;
      OP_REQUIRES_OK(c, c->allocate_output(i, in.shape(), &out));
      ins.push_back({in.tensor_data().data(), ShapeDims(in.shape())});
      outs.push_back({const_cast<char*>(out->tensor_data().data()),
                      ShapeDims(out->shape())});
    }
    const std::string err = CallDispatch("grouped_allreduce", name_, rop_,
                                         0, pre_, post_, psid_, dtype, ins,
                                         outs);
    OP_REQUIRES(c, err.empty(), errors::Internal(err));
  }

 private:
  std::string name_, rop_;
  int64_t psid_ = -1;
  float pre_, post_;
};

// ---------------------------------------------------------------------
// typed-FFI custom-call handlers (XLA:CPU execution)
// ---------------------------------------------------------------------

std::string FfiDtypeName(ffi::AnyBuffer b) {
  switch (b.element_type()) {
    case ffi::F32: return "float32";
    case ffi::F64: return "float64";
    case ffi::S32: return "int32";
    case ffi::S64: return "int64";
    case ffi::BF16: return "bfloat16";
    case ffi::F16: return "float16";
    default: return "unsupported";
  }
}

std::vector<int64_t> FfiDims(ffi::AnyBuffer b) {
  auto d = b.dimensions();
  return std::vector<int64_t>(d.begin(), d.end());
}

ffi::Error HvdCollectiveFfi(std::string_view kind, std::string_view name,
                            std::string_view rop, int64_t root, float pre,
                            float post, int64_t psid, ffi::AnyBuffer x,
                            ffi::Result<ffi::AnyBuffer> y) {
  const std::string dtype = FfiDtypeName(x);
  if (dtype == "unsupported") {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "unsupported dtype");
  }
  std::vector<BufferRef> ins{{x.untyped_data(), FfiDims(x)}};
  std::vector<MutBufferRef> outs{{y->untyped_data(), FfiDims(*y)}};
  const std::string err =
      CallDispatch(std::string(kind), std::string(name), std::string(rop),
                   root, pre, post, psid, dtype, ins, outs);
  if (!err.empty()) return ffi::Error(ffi::ErrorCode::kInternal, err);
  return ffi::Error::Success();
}
XLA_FFI_DEFINE_HANDLER(kHvdCollective, HvdCollectiveFfi,
                       ffi::Ffi::Bind()
                           .Attr<std::string_view>("kind")
                           .Attr<std::string_view>("name")
                           .Attr<std::string_view>("rop")
                           .Attr<int64_t>("root")
                           .Attr<float>("pre")
                           .Attr<float>("post")
                           .Attr<int64_t>("psid")
                           .Arg<ffi::AnyBuffer>()
                           .Ret<ffi::AnyBuffer>());
XLA_FFI_REGISTER_HANDLER(ffi::GetXlaFfiApi(), "hvd_torch_collective_ffi",
                         "Host", kHvdCollective);

ffi::Error HvdGroupedFfi(std::string_view name, std::string_view rop,
                         float pre, float post, int64_t psid,
                         ffi::RemainingArgs xs, ffi::RemainingRets ys) {
  if (xs.size() == 0 || xs.size() != ys.size()) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "grouped allreduce arg/ret arity mismatch");
  }
  std::vector<BufferRef> ins;
  std::vector<MutBufferRef> outs;
  std::string dtype;
  for (size_t i = 0; i < xs.size(); ++i) {
    auto x = xs.get<ffi::AnyBuffer>(i);
    auto y = ys.get<ffi::AnyBuffer>(i);
    if (!x.has_value() || !y.has_value()) {
      return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                        "grouped allreduce buffer access failed");
    }
    const std::string dt = FfiDtypeName(*x);
    if (dt == "unsupported" || (!dtype.empty() && dt != dtype)) {
      return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                        "grouped allreduce requires one supported dtype");
    }
    dtype = dt;
    ins.push_back({x->untyped_data(), FfiDims(*x)});
    outs.push_back({(*y)->untyped_data(), FfiDims(**y)});
  }
  const std::string err =
      CallDispatch("grouped_allreduce", std::string(name), std::string(rop),
                   0, pre, post, psid, dtype, ins, outs);
  if (!err.empty()) return ffi::Error(ffi::ErrorCode::kInternal, err);
  return ffi::Error::Success();
}
XLA_FFI_DEFINE_HANDLER(kHvdGrouped, HvdGroupedFfi,
                       ffi::Ffi::Bind()
                           .Attr<std::string_view>("name")
                           .Attr<std::string_view>("rop")
                           .Attr<float>("pre")
                           .Attr<float>("post")
                           .Attr<int64_t>("psid")
                           .RemainingArgs()
                           .RemainingRets());
XLA_FFI_REGISTER_HANDLER(ffi::GetXlaFfiApi(), "hvd_torch_grouped_ffi",
                         "Host", kHvdGrouped);

// ---------------------------------------------------------------------
// XLA kernels (lower to the FFI custom calls)
// ---------------------------------------------------------------------

std::string EscapeAttr(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    if (c == '"' || c == '\\') out.push_back('_');
    else out.push_back(c);
  }
  return out;
}

class HvdCollectiveXlaOp : public XlaOpKernel {
 public:
  explicit HvdCollectiveXlaOp(OpKernelConstruction* c) : XlaOpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("kind", &kind_));
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &rop_));
    OP_REQUIRES_OK(c, c->GetAttr("root_rank", &root_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale", &pre_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale", &post_));
    OP_REQUIRES_OK(c, c->GetAttr("nproc", &nproc_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &psid_));
  }

  void Compile(XlaOpKernelContext* ctx) override {
    auto shape_or = ctx->InputXlaShape(0);
    OP_REQUIRES_OK(ctx, shape_or.status());
    xla::Shape shape = shape_or.value();
    std::vector<int64_t> dims(shape.dimensions().begin(),
                              shape.dimensions().end());
    if (kind_ == "allgather" && !dims.empty()) {
      dims[0] *= nproc_;
    } else if (kind_ == "reducescatter" && !dims.empty()) {
      dims[0] /= nproc_;
    }
    xla::Shape out_shape =
        xla::ShapeUtil::MakeShape(shape.element_type(), dims);
    char fbuf[64];
    std::string cfg = "{kind = \"" + EscapeAttr(kind_) + "\", name = \"" +
                      EscapeAttr(name_) + "\", rop = \"" +
                      EscapeAttr(rop_) + "\", root = " +
                      std::to_string(root_) + " : i64, psid = " +
                      std::to_string(psid_) + " : i64";
    snprintf(fbuf, sizeof(fbuf), ", pre = %.8e : f32", pre_);
    cfg += fbuf;
    snprintf(fbuf, sizeof(fbuf), ", post = %.8e : f32}", post_);
    cfg += fbuf;
    xla::XlaOp call = xla::CustomCall(
        ctx->builder(), "hvd_torch_collective_ffi", {ctx->Input(0)},
        out_shape, cfg, /*has_side_effect=*/true, {}, nullptr,
        xla::CustomCallSchedule::SCHEDULE_NONE,
        xla::CustomCallApiVersion::API_VERSION_TYPED_FFI);
    ctx->SetOutput(0, call);
  }

 private:
  std::string kind_, name_, rop_;
  int64_t root_, nproc_, psid_;
  float pre_, post_;
};

class HvdGroupedXlaOp : public XlaOpKernel {
 public:
  explicit HvdGroupedXlaOp(OpKernelConstruction* c) : XlaOpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &rop_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale", &pre_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale", &post_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &psid_));
  }

  void Compile(XlaOpKernelContext* ctx) override {
    const int n = ctx->num_inputs();
    std::vector<xla::XlaOp> operands;
    std::vector<xla::Shape> shapes;
    for (int i = 0; i < n; ++i) {
      auto shape_or = ctx->InputXlaShape(i);
      OP_REQUIRES_OK(ctx, shape_or.status());
      shapes.push_back(shape_or.value());
      operands.push_back(ctx->Input(i));
    }
    xla::Shape out_shape = xla::ShapeUtil::MakeTupleShape(shapes);
    char fbuf[64];
    std::string cfg = "{name = \"" + EscapeAttr(name_) + "\", rop = \"" +
                      EscapeAttr(rop_) + "\", psid = " +
                      std::to_string(psid_) + " : i64";
    snprintf(fbuf, sizeof(fbuf), ", pre = %.8e : f32", pre_);
    cfg += fbuf;
    snprintf(fbuf, sizeof(fbuf), ", post = %.8e : f32}", post_);
    cfg += fbuf;
    xla::XlaOp call = xla::CustomCall(
        ctx->builder(), "hvd_torch_grouped_ffi", operands, out_shape, cfg,
        /*has_side_effect=*/true, {}, nullptr,
        xla::CustomCallSchedule::SCHEDULE_NONE,
        xla::CustomCallApiVersion::API_VERSION_TYPED_FFI);
    for (int i = 0; i < n; ++i) {
      ctx->SetOutput(i, xla::GetTupleElement(call, i));
    }
  }

 private:
  std::string name_, rop_;
  int64_t psid_ = -1;
  float pre_, post_;
};

}  // namespace

// ---------------------------------------------------------------------
// op registrations
// ---------------------------------------------------------------------

REGISTER_OP("HorovodTorchCollective")
    .Input("x: T")
    .Output("y: T")
    .Attr("T: {float, double, int32, int64, bfloat16, half}")
    .Attr("kind: string")
    .Attr("tensor_name: string")
    .Attr("reduce_op: string = 'average'")
    .Attr("root_rank: int = 0")
    .Attr("prescale: float = 1.0")
    .Attr("postscale: float = 1.0")
    .Attr("nproc: int = 1")
    .Attr("process_set_id: int = -1")
    .SetIsStateful()
    .SetShapeFn([](shape_inference::InferenceContext* c) {
      std::string kind;
      TF_RETURN_IF_ERROR(c->GetAttr("kind", &kind));
      if (kind != "allgather" && kind != "reducescatter") {
        c->set_output(0, c->input(0));
        return absl::OkStatus();
      }
      int64_t nproc = 1;
      TF_RETURN_IF_ERROR(c->GetAttr("nproc", &nproc));
      shape_inference::ShapeHandle in = c->input(0);
      shape_inference::DimensionHandle d0 = c->Dim(in, 0);
      shape_inference::DimensionHandle d0_out;
      if (kind == "allgather") {
        TF_RETURN_IF_ERROR(c->Multiply(d0, nproc, &d0_out));
      } else {
        TF_RETURN_IF_ERROR(c->Divide(d0, nproc, true, &d0_out));
      }
      shape_inference::ShapeHandle out;
      TF_RETURN_IF_ERROR(c->ReplaceDim(in, 0, d0_out, &out));
      c->set_output(0, out);
      return absl::OkStatus();
    });

REGISTER_KERNEL_BUILDER(Name("HorovodTorchCollective").Device(DEVICE_CPU),
                        HvdCollectiveCpuOp);
REGISTER_XLA_OP(Name("HorovodTorchCollective").Device("XLA_CPU_JIT"),
                HvdCollectiveXlaOp);

REGISTER_OP("HorovodTorchGroupedAllreduce")
    .Input("xs: T")
    .Output("ys: T")
    .Attr("T: list({float, double, int32, int64, bfloat16, half})")
    .Attr("tensor_name: string")
    .Attr("reduce_op: string = 'average'")
    .Attr("prescale: float = 1.0")
    .Attr("postscale: float = 1.0")
    .Attr("process_set_id: int = -1")
    .SetIsStateful()
    .SetShapeFn([](shape_inference::InferenceContext* c) {
      for (int i = 0; i < c->num_inputs(); ++i) {
        c->set_output(i, c->input(i));
      }
      return absl::OkStatus();
    });

REGISTER_KERNEL_BUILDER(
    Name("HorovodTorchGroupedAllreduce").Device(DEVICE_CPU), HvdGroupedCpuOp);
REGISTER_XLA_OP(Name("HorovodTorchGroupedAllreduce").Device("XLA_CPU_JIT"),
                HvdGroupedXlaOp);
